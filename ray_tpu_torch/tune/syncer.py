"""Experiment-directory sync to durable storage.

Counterpart of ``ray_tpu/tune/syncer.py``. Parity: `python/ray/tune/syncer.py` — the reference mirrors
each experiment's driver-side state (tuner.pkl, trial checkpoints) to a
cloud `upload_dir` so a dead head node doesn't lose the sweep. Here the
backend is pluggable by URI scheme: `file://` ships in-tree (covers NFS /
mounted buckets), and `register_backend`
adds real object-store clients without touching the Tuner.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import Callable
from urllib.parse import urlparse


class StorageBackend:
    def upload(self, local_dir: str, uri: str) -> None:
        raise NotImplementedError

    def download(self, uri: str, local_dir: str) -> None:
        raise NotImplementedError


class _FileBackend(StorageBackend):
    """file://<abs path> — local/NFS/FUSE-mounted destinations."""

    @staticmethod
    def _path(uri: str) -> str:
        p = urlparse(uri)
        return (p.netloc + p.path) if p.netloc else p.path

    def upload(self, local_dir: str, uri: str) -> None:
        dst = self._path(uri)
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(local_dir, dst, dirs_exist_ok=True)

    def download(self, uri: str, local_dir: str) -> None:
        src = self._path(uri)
        if not os.path.isdir(src):
            raise FileNotFoundError(f"no synced experiment at {uri}")
        os.makedirs(local_dir, exist_ok=True)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)


_BACKENDS: dict[str, Callable[[], StorageBackend]] = {
    "file": _FileBackend,
}


def register_backend(scheme: str,
                     factory: Callable[[], StorageBackend]) -> None:
    _BACKENDS[scheme] = factory


def get_backend(uri: str) -> StorageBackend:
    scheme = urlparse(uri).scheme or "file"
    factory = _BACKENDS.get(scheme)
    if factory is None:
        raise ValueError(
            f"no storage backend for scheme {scheme!r} "
            f"(registered: {sorted(_BACKENDS)}); add one with "
            "ray_tpu_torch.tune.syncer.register_backend")
    return factory()


@dataclass
class SyncConfig:
    """RunConfig.sync_config: mirror the experiment dir to `upload_dir`
    every `sync_period_s` (and always on completion)."""

    upload_dir: str
    sync_period_s: float = 30.0


class Syncer:
    def __init__(self, sync_config: SyncConfig, experiment_name: str):
        self.cfg = sync_config
        self.uri = sync_config.upload_dir.rstrip("/") + "/" + experiment_name
        self._backend = get_backend(sync_config.upload_dir)
        self._last = 0.0

    def sync_up_if_due(self, local_dir: str) -> bool:
        if time.monotonic() - self._last < self.cfg.sync_period_s:
            return False
        self.sync_up(local_dir)
        return True

    def sync_up(self, local_dir: str) -> None:
        self._backend.upload(local_dir, self.uri)
        self._last = time.monotonic()

    @staticmethod
    def download_experiment(uri: str, local_dir: str) -> None:
        get_backend(uri).download(uri, local_dir)
