"""Per-execution context visible to user code (ref: runtime_context.py
`get_runtime_context().get_actor_id()` in the reference API).

ContextVars, not thread-locals: async actor tasks interleave on one event
loop thread, and each task's context must stay isolated.
"""

from __future__ import annotations

import contextvars

current_actor_id: contextvars.ContextVar[bytes | None] = (
    contextvars.ContextVar("ray_tpu_current_actor_id", default=None)
)
current_task_id: contextvars.ContextVar[bytes | None] = (
    contextvars.ContextVar("ray_tpu_current_task_id", default=None)
)
