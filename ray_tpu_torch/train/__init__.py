"""Train: data-parallel and sharded training on a gang of worker actors
(counterpart of ``ray_tpu/train``; Ray Train capability parity): the
`TorchTrainer` and its configs, backend and session; the train step on
one controller or across processes (``spmd.py``), an AdamW and an
Adafactor with optax's semantics (``optim.py``), and checkpoints
(``checkpoint.py``). Importing it imports no torch."""

from ray_tpu_torch.train.backend import (Backend, BackendConfig, TorchBackend,
                                         TorchBackendConfig)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.trainer import TorchTrainer, TrainingFailedError
from ray_tpu_torch.train import session

__all__ = [
    "Backend", "BackendConfig", "TorchBackend", "TorchBackendConfig",
    "Checkpoint", "CheckpointConfig", "FailureConfig", "Result", "RunConfig",
    "ScalingConfig", "TorchTrainer", "TrainingFailedError", "session",
]
