"""AIR: the shared glue layer across Train/Tune/Serve/Data.

Counterpart of ``ray_tpu/air`` (parity: ``python/ray/air/``): the
canonical `Checkpoint` artifact (``air/checkpoint.py:61``),
run/scaling/failure/checkpoint configs (``air/config.py``), the
`session` reporting API (``air/session.py``), and `BatchPredictor`
(``train/batch_predictor.py``). The implementations live in the port's
``train`` package (one source of truth); this package is the stable
AIR-named surface plus batch prediction over Data. Importing it imports
no torch.
"""

from ray_tpu_torch.air.batch_predictor import BatchPredictor, Predictor
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train import session

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "Result", "RunConfig",
    "ScalingConfig", "session", "BatchPredictor", "Predictor",
]
