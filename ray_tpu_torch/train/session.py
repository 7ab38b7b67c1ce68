"""Per-worker training session.

Counterpart of ``ray_tpu/train/session.py`` (parity:
``python/ray/air/session.py`` + ``train/_internal/session.py``): the
train loop calls ``session.report(metrics, checkpoint=...)`` and reads
its world rank and size; reports stream back to the trainer through the
worker actor's poll queue. ``get_local_rank`` is the rank among the
gang's ranks on the same node, and ``get_device`` the device the rank
trains on (``cuda:{local_rank % device_count}``, or the CPU when the
backend asked for it; ref: ``ray.train.torch.get_device``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_session_local = threading.local()


class TrainSession:
    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0, dataset_shards: dict | None = None,
                 device: Any = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.device = device
        self.reports: list[dict] = []
        self.latest_checkpoint = None
        self.dataset_shards = dataset_shards or {}
        self.lock = threading.Lock()
        self.finished = False
        self.error: str | None = None

    def report(self, metrics: dict, checkpoint=None) -> None:
        with self.lock:
            entry = dict(metrics)
            entry["_world_rank"] = self.world_rank
            if checkpoint is not None:
                self.latest_checkpoint = checkpoint
                entry["_has_checkpoint"] = True
            self.reports.append(entry)

    def drain(self) -> list[dict]:
        with self.lock:
            out, self.reports = self.reports, []
            return out


def _set_session(s: Optional[TrainSession]) -> None:
    _session_local.session = s


def get_session() -> TrainSession:
    s = getattr(_session_local, "session", None)
    if s is None:
        raise RuntimeError(
            "No train session active — are you inside train_loop_per_worker?"
        )
    return s


def active() -> bool:
    """Whether this thread runs inside a train session."""
    return getattr(_session_local, "session", None) is not None


# Public functional API (ray.air.session parity)

def report(metrics: dict, checkpoint=None) -> None:
    get_session().report(metrics, checkpoint)


def get_world_rank() -> int:
    return get_session().world_rank


def get_world_size() -> int:
    return get_session().world_size


def get_local_rank() -> int:
    return get_session().local_rank


def get_device():
    return get_session().device


def get_dataset_shard(name: str = "train"):
    return get_session().dataset_shards.get(name)


def get_checkpoint():
    return get_session().latest_checkpoint
