"""Host-side collective communication between tasks/actors.

Counterpart of ``ray_tpu/utils/collective.py`` (parity:
``python/ray/util/collective/collective.py:258-655``:
init_collective_group, allreduce/allgather/reducescatter/broadcast/
send/recv/barrier) on the port's runtime.

- **Data-path collectives are ``torch.distributed``**: a train gang's
  gradients and parameters move through its process group (NCCL on the
  card, gloo on the CPU; ``parallel/mesh.py::ProcessMesh``) and never
  touch this module.
- **This module is the host/control-path backend** (Gloo's role in the
  reference): numpy payloads (CPU tensors arrive as numpy) exchanged
  between actors through a named rendezvous actor. Ranks poll for round
  completion, so the rendezvous actor needs no blocking waits or extra
  concurrency.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

import ray_tpu_torch as rt

_REDUCE_OPS = {
    "sum": lambda xs: sum(xs[1:], start=xs[0]),
    "prod": lambda xs: np.prod(np.stack(xs), axis=0),
    "min": lambda xs: np.min(np.stack(xs), axis=0),
    "max": lambda xs: np.max(np.stack(xs), axis=0),
}


class _Rendezvous:
    """Named actor coordinating one collective group."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: dict[str, dict[int, Any]] = {}
        self.results: dict[str, Any] = {}
        self.mailbox: dict[tuple[str, int], Any] = {}

    def contribute(self, round_key: str, rank: int, payload, op: str | None):
        r = self.rounds.setdefault(round_key, {})
        r[rank] = payload
        if len(r) == self.world_size:
            vals = [r[i] for i in range(self.world_size)]
            if op is None:
                self.results[round_key] = vals          # allgather
            else:
                self.results[round_key] = _REDUCE_OPS[op](vals)
            del self.rounds[round_key]
        return True

    def result(self, round_key: str):
        if round_key not in self.results:
            return False, None
        return True, self.results[round_key]

    def ack(self, round_key: str, rank: int):
        """Last rank to ack clears the round result."""
        key = f"{round_key}:acks"
        acks = self.rounds.setdefault(key, {})
        acks[rank] = True
        if len(acks) == self.world_size:
            self.results.pop(round_key, None)
            del self.rounds[key]
        return True

    def send(self, key: str, dst: int, payload):
        self.mailbox[(key, dst)] = payload
        return True

    def recv(self, key: str, dst: int):
        if (key, dst) not in self.mailbox:
            return False, None
        return True, self.mailbox.pop((key, dst))


class _GroupState:
    def __init__(self, name: str, world_size: int, rank: int, actor):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.actor = actor
        self.round = 0


_groups: dict[str, _GroupState] = {}


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join (creating if needed) a named collective group. Call once per
    participant before any collective op (ref: collective.py:120)."""
    actor_name = f"raytpu_torch_collective:{group_name}"
    actor = rt.remote(_Rendezvous).options(
        name=actor_name, get_if_exists=True, lifetime="detached", num_cpus=0,
    ).remote(world_size)
    _groups[group_name] = _GroupState(group_name, world_size, rank, actor)


def destroy_collective_group(group_name: str = "default") -> None:
    st = _groups.pop(group_name, None)
    if st is not None and st.rank == 0:
        try:
            rt.kill(st.actor)
        except Exception:  # graftlint: disable=EXC-SWALLOW (the actor may already be dead)
            pass


def _group(group_name: str) -> _GroupState:
    st = _groups.get(group_name)
    if st is None:
        raise ValueError(
            f"collective group {group_name!r} not initialized in this "
            "process; call init_collective_group first")
    return st


def _run_round(st: _GroupState, payload, op: str | None,
               timeout: float) -> Any:
    key = f"{st.name}:{st.round}"
    st.round += 1
    rt.get(st.actor.contribute.remote(key, st.rank, payload, op),
                timeout=timeout)
    deadline = time.monotonic() + timeout
    while True:
        ready, value = rt.get(st.actor.result.remote(key),
                                   timeout=timeout)
        if ready:
            rt.get(st.actor.ack.remote(key, st.rank), timeout=timeout)
            return value
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"collective round {key} timed out "
                f"({st.world_size}-rank group)")
        time.sleep(0.002)


def allreduce(tensor, group_name: str = "default", op: str = "sum",
              timeout: float = 120.0):
    """Elementwise reduction across all ranks; every rank gets the result."""
    st = _group(group_name)
    return _run_round(st, np.asarray(tensor), op, timeout)


def allgather(tensor, group_name: str = "default", timeout: float = 120.0):
    """→ list of every rank's tensor, ordered by rank."""
    st = _group(group_name)
    return _run_round(st, np.asarray(tensor), None, timeout)


def reducescatter(tensor, group_name: str = "default", op: str = "sum",
                  timeout: float = 120.0):
    """Reduce across ranks, then return this rank's 1/world_size slice
    (axis 0)."""
    st = _group(group_name)
    reduced = _run_round(st, np.asarray(tensor), op, timeout)
    chunks = np.array_split(reduced, st.world_size, axis=0)
    return chunks[st.rank]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout: float = 120.0):
    """Every rank receives src_rank's tensor."""
    st = _group(group_name)
    gathered = _run_round(
        st, np.asarray(tensor) if st.rank == src_rank else None, None,
        timeout)
    return gathered[src_rank]


def barrier(group_name: str = "default", timeout: float = 120.0) -> None:
    st = _group(group_name)
    _run_round(st, None, None, timeout)


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0,
         timeout: float = 120.0) -> None:
    st = _group(group_name)
    key = f"{st.name}:p2p:{st.rank}->{dst_rank}:{tag}"
    rt.get(st.actor.send.remote(key, dst_rank, np.asarray(tensor)),
                timeout=timeout)


def recv(src_rank: int, group_name: str = "default", tag: int = 0,
         timeout: float = 120.0):
    st = _group(group_name)
    key = f"{st.name}:p2p:{src_rank}->{st.rank}:{tag}"
    deadline = time.monotonic() + timeout
    while True:
        ready, value = rt.get(st.actor.recv.remote(key, st.rank),
                                   timeout=timeout)
        if ready:
            return value
        if time.monotonic() > deadline:
            raise TimeoutError(f"recv from rank {src_rank} timed out")
        time.sleep(0.002)
