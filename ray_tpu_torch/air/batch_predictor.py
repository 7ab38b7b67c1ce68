"""Batch inference over Datasets from a Checkpoint.

Counterpart of ``ray_tpu/air/batch_predictor.py`` (parity:
``python/ray/train/batch_predictor.py``): load a trained model once per
worker from an AIR Checkpoint (the port's ``train.checkpoint``), then
map it over a Dataset in batches. The predictor's `predict_batch`
receives whole numpy batches, so a model on the card runs one forward
per batch; with actor compute (``compute=ActorPoolStrategy(...,
resources={"GPU": g})``) the model loads once per actor, not per block.
"""

from __future__ import annotations

from typing import Any, Callable, Type

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Subclass seam: build from checkpoint + predict one batch."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict_batch(self, batch: Any) -> Any:
        raise NotImplementedError


# Per-process predictor cache. The map closure is re-deserialized for every
# block task, so closure state would rebuild the model per block; a stable
# string key captured in the closure survives re-pickling and lands here,
# giving one model load per worker process.
_PREDICTOR_CACHE: dict = {}


class BatchPredictor:
    def __init__(self, checkpoint: Checkpoint, predictor_cls: Type[Predictor],
                 **predictor_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.predictor_kwargs = predictor_kwargs
        # Stable across predict() calls AND closure re-pickling, so every
        # worker loads this (checkpoint, predictor) combination once.
        import hashlib

        import cloudpickle

        self._cache_key = hashlib.sha256(cloudpickle.dumps(
            (predictor_cls.__qualname__, sorted(predictor_kwargs.items()),
             checkpoint._data if checkpoint._data is not None
             else checkpoint._path)
        )).hexdigest()[:32]

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **kwargs)

    def predict(self, dataset, *, batch_size: int | None = None,
                batch_format: str = "numpy", compute=None):
        """→ Dataset of predictions (lazy; executes with the dataset plan).

        With `compute=ActorPoolStrategy(...)` inference runs on a reusable
        actor pool: the predictor builds once per ACTOR (weights load +
        its first-call setup amortize over every block the actor processes) instead
        of relying on the per-process cache of task workers.
        """
        ckpt = self.checkpoint
        predictor_cls = self.predictor_cls
        kwargs = self.predictor_kwargs
        cache_key = self._cache_key

        if compute is not None:
            class _PredictorTransform:
                def __init__(self):
                    self._p = predictor_cls.from_checkpoint(ckpt, **kwargs)

                def __call__(self, batch):
                    return self._p.predict_batch(batch)

            return dataset.map_batches(
                _PredictorTransform, batch_size=batch_size,
                batch_format=batch_format, compute=compute)

        def infer(batch):
            from ray_tpu_torch.air.batch_predictor import _PREDICTOR_CACHE

            p = _PREDICTOR_CACHE.get(cache_key)
            if p is None:
                p = predictor_cls.from_checkpoint(ckpt, **kwargs)
                _PREDICTOR_CACHE[cache_key] = p
            return p.predict_batch(batch)

        return dataset.map_batches(
            infer, batch_size=batch_size, batch_format=batch_format)
