"""Utilities of the port's runtime: asyncio task spawning (``aio``), the
serializability inspector (``check_serialize``), the scheduling
strategy classes (``scheduling_strategies``) and host collectives
between tasks and actors (``collective``), copies of the JAX
package's."""

from ray_tpu_torch.utils.check_serialize import inspect_serializability

__all__ = ["inspect_serializability"]
