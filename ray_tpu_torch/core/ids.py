"""Hierarchically-composed binary IDs.

Capability parity with the reference's ID scheme (`src/ray/
common/id.h:108,133,180`): JobID ⊂ ActorID ⊂ TaskID ⊂ ObjectID, so ownership
and lineage can be recovered from an ID alone. Sizes are kept small and fixed:

    JobID    4 bytes
    ActorID  12 bytes = JobID(4) + unique(8)        (nil unique → not an actor)
    TaskID   20 bytes = ActorID(12) + unique(8)
    ObjectID 24 bytes = TaskID(20) + return_index(4, big-endian)
"""

from __future__ import annotations

import os
from typing import ClassVar


class BaseID:
    SIZE: ClassVar[int] = 16
    __slots__ = ("_bytes",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} needs {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = bytes(binary)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, i: int) -> "JobID":
        return cls(i.to_bytes(4, "big"))


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(8))

    @property
    def job_id(self) -> JobID:
        return JobID(self._bytes[:4])


class TaskID(BaseID):
    SIZE = 20

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        return cls(ActorID(job_id.binary() + b"\x00" * 8).binary() + os.urandom(8))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + os.urandom(8))

    @property
    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:12])

    @property
    def job_id(self) -> JobID:
        return JobID(self._bytes[:4])


class ObjectID(BaseID):
    SIZE = 24

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def from_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index space.
        return cls(task_id.binary() + (0x8000_0000 | put_index).to_bytes(4, "big"))

    @property
    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:20])

    @property
    def return_index(self) -> int:
        return int.from_bytes(self._bytes[20:], "big") & 0x7FFF_FFFF

    @property
    def is_put(self) -> bool:
        return bool(self._bytes[20] & 0x80)

    @property
    def job_id(self) -> JobID:
        return JobID(self._bytes[:4])
