"""Distributed FIFO queue backed by an actor.

Counterpart of ``ray_tpu/utils/queue.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/util/queue.py` — put/get with
block/timeout, nowait variants, qsize/empty/full. Blocking semantics are
client-side polling against the queue actor (the actor itself never blocks,
so one actor serves any number of producers/consumers).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import ray_tpu_torch as rt


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()

    def qsize(self) -> int:
        return len(self.items)

    def try_put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def try_put_batch(self, items) -> bool:
        if self.maxsize > 0 and len(self.items) + len(items) > self.maxsize:
            return False
        self.items.extend(items)
        return True

    def try_get(self):
        if not self.items:
            return False, None
        return True, self.items.popleft()

    def try_get_batch(self, n: int):
        out = []
        while self.items and len(out) < n:
            out.append(self.items.popleft())
        return out


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: dict | None = None):
        self.maxsize = maxsize
        cls = rt.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def qsize(self) -> int:
        return rt.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def put(self, item, block: bool = True, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if rt.get(self.actor.try_put.remote(item)):
                return
            if not block:
                raise Full()
            if deadline is not None and time.monotonic() > deadline:
                raise Full()
            time.sleep(0.005)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items) -> None:
        if not rt.get(self.actor.try_put_batch.remote(list(items))):
            raise Full()

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = rt.get(self.actor.try_get.remote())
            if ok:
                return item
            if not block:
                raise Empty()
            if deadline is not None and time.monotonic() > deadline:
                raise Empty()
            time.sleep(0.005)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> list:
        return rt.get(self.actor.try_get_batch.remote(num_items))

    def shutdown(self) -> None:
        rt.kill(self.actor)
