"""WorkerGroup: gang of train-worker actors.

Counterpart of ``ray_tpu/train/worker_group.py`` (parity:
``python/ray/train/_internal/worker_group.py`` + ``backend_executor.py``).
Each worker is an actor of the port's runtime hosting one training
process with one device; the train fn runs on a background thread so
the actor stays responsive to poll() for streamed metrics (the
reference streams through a result queue).

The runtime assigns no GPUs to processes (no ``CUDA_VISIBLE_DEVICES``),
so the group numbers each rank among the gang's ranks on its node (its
local rank) and the rank trains on ``cuda:{local_rank % device_count}``.
The current CUDA device is per thread: `setup_torch` sets it on the
thread that joins the process group, and the train thread sets it
again before the train fn runs.
"""

from __future__ import annotations

import datetime
import os
import threading
import traceback
from typing import Any

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization


class TrainWorker:
    """Actor hosting one training process."""

    def __init__(self, rank: int, world_size: int, env_vars: dict | None = None,
                 num_cpus: float | None = None):
        self.rank = rank
        self.world_size = world_size
        self.num_cpus = num_cpus
        for k, v in (env_vars or {}).items():
            os.environ[k] = v
        self.local_rank = 0
        self.device = None
        self.session = None
        self.thread: threading.Thread | None = None
        self._done = False
        self._error: str | None = None
        self._result: Any = None

    def node_id(self) -> str | None:
        return rt.get_runtime_context().get_node_id()

    def set_local_rank(self, local_rank: int) -> bool:
        self.local_rank = local_rank
        return True

    # ---- backend hooks ----

    def setup_torch(self, device=None, backend=None, master=None,
                    world_size=1):
        """Take this rank's device and, given ``master`` (host:port of
        rank 0's store), join the process group. ``device`` None is cuda
        (raises without a GPU), ``"cpu"`` the CPU."""
        import torch

        from ray_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device(
                "cuda", self.local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        elif self.num_cpus:
            # A CPU rank computes on the CPUs it was granted, as the
            # reference's workers run with OMP_NUM_THREADS = num_cpus:
            # ranks sharing a host would otherwise each spin a thread
            # per core.
            torch.set_num_threads(max(1, int(self.num_cpus)))
        self.device = dev
        if master:
            import torch.distributed as dist

            from ray_tpu_torch.core.config import runtime_config

            cfg = runtime_config()
            host, port = master.rsplit(":", 1)
            store = dist.TCPStore(
                host, int(port), world_size, is_master=self.rank == 0,
                timeout=datetime.timedelta(
                    seconds=cfg.train_rendezvous_timeout_s))
            nccl = backend == "nccl"
            dist.init_process_group(
                backend, store=store, rank=self.rank, world_size=world_size,
                timeout=datetime.timedelta(
                    seconds=cfg.train_cpu_collective_timeout_s),
                **({"device_id": dev} if nccl else {}))
            # Connect every rank NOW, while the skew between ranks is only
            # actor boot: gloo's full-mesh connect waits on the store with
            # a hard key timeout, and a rank that reaches its first real
            # collective after a long warm-up (a kernel build, a first
            # step) could miss it; a barrier here cannot.
            dist.barrier(**({"device_ids": [dev.index]} if nccl else {}))
        return {"rank": self.rank, "local_rank": self.local_rank,
                "device": str(dev), "backend": backend if master else None}

    def teardown_torch(self):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        return True

    # ---- training ----

    def run_train_fn(self, fn_blob: bytes, config: dict,
                     dataset_shards: dict | None = None,
                     initial_checkpoint=None) -> bool:
        from ray_tpu_torch.train.session import TrainSession

        fn = serialization.unpack(fn_blob)
        self.session = TrainSession(
            self.rank, self.world_size, self.local_rank,
            dataset_shards=dataset_shards, device=self.device)
        if initial_checkpoint is not None:
            # restored trial (Tune resume / PBT exploit): visible via
            # session.get_checkpoint()
            self.session.latest_checkpoint = initial_checkpoint
        self._done = False
        self._error = None

        def runner():
            from ray_tpu_torch.train import session as session_mod

            session_mod._set_session(self.session)
            try:
                if self.device is not None and self.device.type == "cuda":
                    import torch

                    torch.cuda.set_device(self.device)
                import inspect

                takes_config = bool(
                    inspect.signature(fn).parameters
                )
                if takes_config:
                    self._result = fn(config or {})
                else:
                    self._result = fn()
            except BaseException:
                self._error = traceback.format_exc()
            finally:
                self._done = True

        self.thread = threading.Thread(target=runner, daemon=True)
        self.thread.start()
        return True

    def run_trial(self, device, fn_blob: bytes, config: dict,
                  initial_checkpoint=None) -> bool:
        """A Tune trial: take ``device`` (``setup_torch`` without a
        process group), then start the train fn, in one call so the two
        cannot interleave on this threaded actor. A device this process
        cannot take (no GPU for the default) fails the trial."""
        try:
            self.setup_torch(device, master=None)
        except Exception:
            self._error = traceback.format_exc()
            self._done = True
            return False
        return self.run_train_fn(fn_blob, config, None, initial_checkpoint)

    def poll(self) -> dict:
        reports = self.session.drain() if self.session else []
        out = {"reports": reports, "done": self._done, "error": self._error}
        if self._done and self.session and self.session.latest_checkpoint:
            out["checkpoint"] = self.session.latest_checkpoint
        return out

    def get_result(self):
        return self._result

    def get_checkpoint(self):
        return self.session.latest_checkpoint if self.session else None

    def shutdown(self):
        return True


def local_ranks(node_ids: list) -> list[int]:
    """Each rank's index among the ranks on its node, in rank order."""
    seen: dict = {}
    out = []
    for node in node_ids:
        out.append(seen.get(node, 0))
        seen[node] = out[-1] + 1
    return out


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: dict[str, float],
                 env_vars: dict | None = None, max_restarts: int = 0):
        actor_cls = rt.remote(TrainWorker).options(
            resources=resources_per_worker, max_restarts=max_restarts,
            max_concurrency=4,   # poll() must interleave with run_train_fn
        )
        self.workers = [
            actor_cls.remote(rank, num_workers, env_vars,
                             resources_per_worker.get("CPU"))
            for rank in range(num_workers)
        ]
        self.local_ranks = local_ranks(self.run_on_all("node_id"))
        rt.get([w.set_local_rank.remote(lr)
                for w, lr in zip(self.workers, self.local_ranks)], timeout=300)

    def __len__(self):
        return len(self.workers)

    def run_on_all(self, method: str, *args, timeout: float | None = 300, **kw):
        refs = [getattr(w, method).remote(*args, **kw) for w in self.workers]
        return rt.get(refs, timeout=timeout)

    def run_on_rank(self, rank: int, method: str, *args, timeout=300, **kw):
        return rt.get(
            getattr(self.workers[rank], method).remote(*args, **kw),
            timeout=timeout,
        )

    def shutdown(self):
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:  # graftlint: disable=EXC-SWALLOW (the actor may already be dead)
                pass
