"""ActorPool: load-balance work over a fixed set of actors.

Counterpart of ``ray_tpu/utils/actor_pool.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/util/actor_pool.py` — map/map_unordered,
submit/get_next(_unordered), push/pop_idle.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import ray_tpu_torch as rt


class ActorPool:
    def __init__(self, actors: Iterable):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending: list[tuple[Callable, Any]] = []

    def submit(self, fn: Callable, value) -> None:
        """fn(actor, value) -> ObjectRef. Queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending.append((fn, value))

    def _drain_pending(self) -> None:
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending)

    def get_next(self, timeout: float | None = None):
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no pending tasks")
        idx = self._next_return_index
        # Ordered consumption ⇒ the oldest undelivered index is always the
        # oldest dispatched task; if it is still queued every actor is idle
        # and one drain dispatches it.
        if idx not in self._index_to_future:
            self._drain_pending()
        ref = self._index_to_future.pop(idx)
        self._next_return_index += 1
        value = rt.get(ref, timeout=timeout)
        self._idle.append(self._future_to_actor.pop(ref))
        self._drain_pending()
        return value

    def get_next_unordered(self, timeout: float | None = None):
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no pending tasks")
        self._drain_pending()
        refs = list(self._future_to_actor)
        ready, _ = rt.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == ref:
                del self._index_to_future[idx]
        value = rt.get(ref)
        self._idle.append(self._future_to_actor.pop(ref))
        self._drain_pending()
        return value

    def map(self, fn: Callable, values: Iterable):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._idle.append(actor)
        self._drain_pending()
