"""Public exception surface (ref: `python/ray/exceptions.py`).

The reference exposes task/actor/object failures as a typed hierarchy under
`ray.exceptions`; users catch these to distinguish app errors from system
failures. Here the canonical classes live where they are raised (api.py,
core/client.py) — this module is the stable public import path.
"""

from ray_tpu_torch.api import (
    ActorDiedError,
    ActorUnavailableError,
    RayTaskError,
    TaskCancelledError,
)
from ray_tpu_torch.core.client import GetTimeoutError

# The reference's RayActorError == "actor died while executing the task".
RayActorError = ActorDiedError

__all__ = [
    "RayTaskError",
    "TaskCancelledError",
    "GetTimeoutError",
    "ActorDiedError",
    "ActorUnavailableError",
    "RayActorError",
]
