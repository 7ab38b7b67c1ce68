"""Tune: distributed hyperparameter search (Ray Tune capability parity).

Counterpart of ``ray_tpu/tune``, with the reference's exports. Trials
are the port's ``TrainWorker`` actors on the device the ``Tuner`` names
(``device=None`` is cuda and raises at ``fit`` without a GPU; ``"cpu"``
for tests). Importing it imports no torch."""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    BayesOptSearcher,
    BOHBSearcher,
    ExternalSearcher,
    RandomSearcher,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, Trial, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler", "FIFOScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PB2", "PopulationBasedTraining",
    "Searcher", "RandomSearcher", "TPESearcher", "BayesOptSearcher",
    "BOHBSearcher", "ExternalSearcher",
    "BasicVariantGenerator", "choice", "grid_search", "loguniform",
    "randint", "uniform", "ResultGrid", "Trial", "TuneConfig", "Tuner",
]
