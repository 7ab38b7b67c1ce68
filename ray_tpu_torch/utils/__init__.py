"""Utilities of the port's runtime: the actor pool, the queue and the
multiprocessing shim (``actor_pool``, ``queue``, ``multiprocessing``),
asyncio task spawning (``aio``), the serializability inspector
(``check_serialize``), the scheduling strategy classes
(``scheduling_strategies``) and host collectives between tasks and
actors (``collective``), copies of the JAX package's, with its
exports. Importing it imports no torch."""

from ray_tpu_torch.utils.actor_pool import ActorPool
from ray_tpu_torch.utils.check_serialize import inspect_serializability
from ray_tpu_torch.utils.queue import Empty, Full, Queue

__all__ = ["ActorPool", "Queue", "Empty", "Full", "inspect_serializability"]
