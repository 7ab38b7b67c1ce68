"""Collective backend setup for train workers.

Counterpart of ``ray_tpu/train/backend.py`` (parity:
``python/ray/train/backend.py:55,68`` Backend.on_start and
``train/torch/config.py:120-174`` _TorchBackend → init_process_group).
The process group is ``torch.distributed``: NCCL on the card, gloo on
the CPU (the tests). Every rank holds one device; the rank's own
single-controller meshes (sp, ep, pp) run inside it.
"""

from __future__ import annotations

import dataclasses
import socket


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks run around the worker group lifecycle."""

    def on_start(self, worker_group, backend_config) -> None:  # noqa: ARG002
        pass

    def on_shutdown(self, worker_group, backend_config) -> None:  # noqa: ARG002
        pass


@dataclasses.dataclass
class TorchBackendConfig(BackendConfig):
    device: str | None = None          # None = cuda (raises without a GPU); "cpu" (tests)
    backend: str | None = None         # None = by device: nccl on cuda, gloo on the CPU
    master_port: int | None = None
    init_distributed: bool = True      # False for single-worker local mode

    def backend_cls(self):
        return TorchBackend

    @property
    def _backend(self) -> str:
        if self.backend is not None:
            return self.backend
        return "gloo" if self.device == "cpu" else "nccl"


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchBackendConfig) -> None:
        n = len(worker_group)
        if not backend_config.init_distributed or n == 0:
            worker_group.run_on_all("setup_torch",
                                    device=backend_config.device,
                                    master=None, world_size=n)
            return
        port = backend_config.master_port or find_free_port()
        # Every rank must reach init_process_group concurrently (its store
        # and the barrier after it wait for all), so fire the actor tasks
        # without waiting in between.
        worker_group.run_on_all("setup_torch",
                                device=backend_config.device,
                                backend=backend_config._backend,
                                master=f"127.0.0.1:{port}", world_size=n)

    def on_shutdown(self, worker_group, backend_config) -> None:
        try:
            worker_group.run_on_all("teardown_torch", timeout=30)
        except Exception:  # graftlint: disable=EXC-SWALLOW (best-effort teardown; the group is killed next)
            pass
