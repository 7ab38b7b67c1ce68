"""Train/AIR config objects.

Counterpart of ``ray_tpu/train/config.py`` (parity:
``python/ray/air/config.py:79,452,511,640``: ScalingConfig /
FailureConfig / CheckpointConfig / RunConfig), field for field, with
``use_gpu`` in the place of ``use_tpu``: a worker is one training
process holding one device, and ``use_gpu`` asks for the runtime's
``"GPU"`` resource. ``topology`` stays a hint.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: dict[str, float] | None = None
    topology: str | None = None          # a gang hint, e.g. "h100-8"
    placement_strategy: str = "PACK"

    @property
    def _resources(self) -> dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"CPU": 1, "GPU": 1} if self.use_gpu else {"CPU": 1}


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    # Mirror the experiment dir to durable storage (ref: tune/syncer.py
    # SyncConfig upload_dir).
    sync_config: Any = None
    verbose: int = 0


@dataclasses.dataclass
class Result:
    metrics: dict[str, Any] | None
    checkpoint: Any | None
    error: Exception | None = None
    metrics_history: list[dict[str, Any]] = dataclasses.field(default_factory=list)
