"""Asyncio helpers.

`spawn` exists because asyncio's task registry holds tasks WEAKLY: a
fire-and-forget `ensure_future(...)` with no surviving reference can be
garbage-collected while pending — its finally blocks run (GeneratorExit)
but its work silently never completes. For a server loop that means
heartbeats stop; for a dispatch coroutine it means a reply never arrives
and the caller hangs. Every fire-and-forget coroutine in the runtime goes
through `spawn`, which pins the task until it finishes.
"""

from __future__ import annotations

import asyncio

_TASKS: set = set()


def spawn(coro) -> asyncio.Task:
    """ensure_future + a strong reference until completion."""
    t = asyncio.ensure_future(coro)
    _TASKS.add(t)
    t.add_done_callback(_TASKS.discard)
    return t
