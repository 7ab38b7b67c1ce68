"""TorchTrainer: data-parallel and sharded training on a gang of worker
actors.

Counterpart of ``ray_tpu/train/trainer.py``'s ``JaxTrainer`` (parity:
``python/ray/train/base_trainer.py:339`` fit +
``data_parallel_trainer.py:329`` training_loop +
``_internal/backend_executor.py``), with the same fit loop. One worker
is one training process with one device; the backend joins the workers
in a ``torch.distributed`` process group, and inside each worker the
train loop builds its process mesh (``parallel/mesh.py::make_mesh``)
and its step (``train/spmd.py::build_training(..., process_mesh=)``).
"""

from __future__ import annotations

import time
from typing import Callable

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization
from ray_tpu_torch.train.backend import BackendConfig, TorchBackendConfig
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        backend_config: BackendConfig | None = None,
        run_config: RunConfig | None = None,
        datasets: dict | None = None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.backend_config = backend_config or TorchBackendConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self._callbacks: list[Callable[[list[dict]], None]] = []

    def add_report_callback(self, cb: Callable[[list[dict]], None]) -> None:
        """cb(new_reports) — used by the Tune integration for streaming."""
        self._callbacks.append(cb)

    def fit(self, poll_interval: float = 0.2, timeout: float | None = None) -> Result:
        sc = self.scaling_config
        group = WorkerGroup(sc.num_workers, sc._resources)
        backend = self.backend_config.backend_cls()()
        history: list[dict] = []
        checkpoint = None
        error: str | None = None
        try:
            backend.on_start(group, self.backend_config)
            # Shard datasets across workers (split by worker rank).
            shards_per_rank = self._split_datasets(sc.num_workers)
            fn_blob = serialization.pack(self.train_loop)
            run_refs = [
                group.workers[rank].run_train_fn.remote(
                    fn_blob, self.train_loop_config, shards_per_rank[rank]
                )
                for rank in range(sc.num_workers)
            ]
            rt.get(run_refs, timeout=120)  # surfaces launch errors
            deadline = None if timeout is None else time.monotonic() + timeout
            done = [False] * sc.num_workers
            while not all(done):
                if deadline is not None and time.monotonic() > deadline:
                    error = "training timed out"
                    break
                time.sleep(poll_interval)
                new_reports: list[dict] = []
                for rank, w in enumerate(group.workers):
                    if done[rank]:
                        continue
                    p = rt.get(w.poll.remote(), timeout=60)
                    new_reports.extend(p["reports"])
                    if p["error"]:
                        error = p["error"]
                        done[rank] = True
                    elif p["done"]:
                        done[rank] = True
                        if rank == 0 and p.get("checkpoint") is not None:
                            checkpoint = p["checkpoint"]
                if new_reports:
                    history.extend(new_reports)
                    for cb in self._callbacks:
                        cb(new_reports)
                if error:
                    break
            if checkpoint is None and not error:
                checkpoint = group.run_on_rank(0, "get_checkpoint")
        finally:
            try:
                backend.on_shutdown(group, self.backend_config)
            except Exception:  # graftlint: disable=EXC-SWALLOW (best-effort teardown before the kill)
                pass
            group.shutdown()
        if error:
            raise TrainingFailedError(error)
        rank0 = [r for r in history if r.get("_world_rank") == 0]
        return Result(
            metrics=rank0[-1] if rank0 else None,
            checkpoint=checkpoint,
            metrics_history=history,
        )

    def _split_datasets(self, num_workers: int) -> list[dict]:
        shards: list[dict] = [dict() for _ in range(num_workers)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "split"):
                parts = ds.split(num_workers)
                for rank in range(num_workers):
                    shards[rank][name] = parts[rank]
            else:
                for rank in range(num_workers):
                    shards[rank][name] = ds
        return shards
