"""Compute strategies for Dataset map stages.

Counterpart of ``ray_tpu/data/compute.py`` on the port's runtime
(parity: ``python/ray/data/_internal/compute.py:88``, ActorPoolStrategy):
stateful block transforms run on a pool of reusable actors instead of
stateless tasks, so per-actor state (model weights, a built forward) is
built ONCE per actor and amortized over many blocks. The pool
autoscales between min_size and max_size based on in-flight depth.
``resources={"GPU": g}`` asks each pool actor for the runtime's
``"GPU"`` resource, as ``num_gpus`` does elsewhere in the port: the
actor is placed where the card's share is free and its transform builds
its model on ``cuda`` (no ``CUDA_VISIBLE_DEVICES`` masking).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import ray_tpu_torch as rt


@dataclass(frozen=True)
class ActorPoolStrategy:
    """map_batches(fn, compute=ActorPoolStrategy(2, 8)).

    min_size actors start immediately; when every actor already has
    max_tasks_in_flight blocks queued and more remain, the pool grows (up
    to max_size). `fn` may be a class: it is constructed once per actor.
    """

    min_size: int = 1
    max_size: int | None = None
    max_tasks_in_flight: int = 2
    resources: dict | None = None

    def __post_init__(self):
        if self.min_size < 1:
            raise ValueError("min_size must be >= 1")
        if self.max_size is not None and self.max_size < self.min_size:
            raise ValueError("max_size < min_size")


class _BlockMapActor:
    """Hosts one constructed transform; applies it to blocks serially."""

    def __init__(self, ctor_packed: bytes):
        from ray_tpu_torch.core import serialization

        make_apply = serialization.unpack(ctor_packed)
        self._apply = make_apply()

    def apply(self, blk):
        return self._apply(blk)

    def ping(self) -> bool:
        return True


def run_actor_map(ctor_packed: bytes, refs: list,
                  strat: ActorPoolStrategy) -> list:
    """Map every block ref through an autoscaling actor pool.

    Streaming ready-queue dispatch (ref: _internal/compute.py:88): result
    refs return to the caller as soon as every block is DISPATCHED, not
    completed — downstream task stages submit on those refs and start per
    block as it lands, so stages overlap. Each wait round touches only the
    outstanding window (≤ pool_size × max_tasks_in_flight refs), never the
    whole block list — dispatch is O(blocks × window), not O(blocks²).
    The pool is reaped by a monitor thread once all blocks complete.
    """
    if not refs:
        return []
    max_size = strat.max_size or max(strat.min_size, len(refs))

    def spawn():
        opts = {}
        if strat.resources:
            opts["resources"] = dict(strat.resources)
        cls = rt.remote(_BlockMapActor)
        if opts:
            cls = cls.options(**opts)
        return cls.remote(ctor_packed)

    actors = [spawn() for _ in range(strat.min_size)]
    counts = [0] * len(actors)
    results: list = []
    # result ref id → actor index, for the bounded in-flight window only.
    outstanding: dict[bytes, tuple] = {}

    def reap_one() -> None:
        ready, _ = rt.wait(
            [r for (r, _j) in outstanding.values()],
            num_returns=1, timeout=None)
        for r in ready:
            _ref, j = outstanding.pop(r.id.binary())
            counts[j] -= 1

    for blk_ref in refs:
        # Opportunistically drain finished work (non-blocking) so counts
        # reflect reality before choosing an actor.
        if outstanding:
            done, _ = rt.wait(
                [r for (r, _j) in outstanding.values()],
                num_returns=len(outstanding), timeout=0)
            for r in done:
                _ref, j = outstanding.pop(r.id.binary())
                counts[j] -= 1
        j = min(range(len(actors)), key=lambda k: counts[k])
        if counts[j] >= strat.max_tasks_in_flight and len(actors) < max_size:
            actors.append(spawn())
            counts.append(0)
            j = len(actors) - 1
        while counts[j] >= strat.max_tasks_in_flight:
            reap_one()
            j = min(range(len(actors)), key=lambda k: counts[k])
        out = actors[j].apply.remote(blk_ref)
        results.append(out)
        outstanding[out.id.binary()] = (out, j)
        counts[j] += 1

    # The reaper outlives this call (it may run after the driver shuts
    # down) — pin it to THIS client: a bare rt.wait would lazily
    # re-initialize a fresh cluster via _ensure_client after shutdown.
    from ray_tpu_torch import api as _api

    client = _api._ensure_client()

    def _reaper():
        # Actors must outlive their queued work; blocks stream to
        # consumers meanwhile.
        try:
            client.wait(results, len(results), None)
        except Exception:
            pass
        for a in actors:
            try:
                client.kill_actor(a._actor_id.binary(), True)
            except Exception:
                pass

    import threading

    threading.Thread(target=_reaper, daemon=True,
                     name="actor-pool-reaper").start()
    return results
