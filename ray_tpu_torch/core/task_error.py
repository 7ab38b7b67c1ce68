"""TaskError: stored as a failed task's result; get() re-raises.

Lives in its own module (not worker.py) because worker.py executes as
__main__ in worker processes and __main__-defined classes pickle by value,
breaking cross-process isinstance checks.

Parity: RayTaskError semantics (`python/ray/exceptions.py`) —
errors-as-objects so failures flow through the object store like any result.
"""

from __future__ import annotations

from typing import Any


class TaskError:
    def __init__(self, exc_type: str, message: str, tb: str, cause: Any = None):
        self.exc_type = exc_type
        self.message = message
        self.tb = tb
        self.cause = cause

    def to_exception(self) -> Exception:
        from ray_tpu_torch.api import (
            ActorDiedError,
            ActorUnavailableError,
            RayTaskError,
            TaskCancelledError,
        )

        # Actor-death results surface as the TYPED exception (all are
        # RayTaskError subclasses, so broad catches keep working): Serve's
        # controller and proxies key failover decisions off the class, not
        # off string-matching the message.
        cls = {
            "TaskCancelledError": TaskCancelledError,
            "ActorDiedError": ActorDiedError,
            "ActorUnavailableError": ActorUnavailableError,
        }.get(self.exc_type, RayTaskError)
        return cls(self.exc_type, self.message, self.tb)

    def __repr__(self):
        return f"TaskError({self.exc_type}: {self.message})"
