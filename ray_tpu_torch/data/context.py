"""DataContext: execution-wide Data settings.

Counterpart of ``ray_tpu/data/context.py`` (parity:
``python/ray/data/context.py:29``, DatasetContext / DataContext),
field for field — notably `target_max_block_size`, which drives dynamic
block splitting: a map task whose output exceeds the target yields
multiple sub-blocks (dynamic generator returns) instead of one
oversized block, so a skewed input cannot hand a worker an unboundedly
large object.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DataContext:
    # Map outputs above this many bytes are split into ceil(size/target)
    # sub-blocks. 0 disables splitting.
    target_max_block_size: int = 128 * 1024**2
    enable_dynamic_block_splitting: bool = True
    # True restricts the byte bound to expanding stages (flat_map /
    # map_batches), keeping 1:1 map chains fully lazy — at the cost of
    # unbounded output blocks from byte-inflating maps (e.g. decode).
    split_expanding_only: bool = False

    _current: "DataContext | None" = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = cls()
        return cls._current


__all__ = ["DataContext"]
