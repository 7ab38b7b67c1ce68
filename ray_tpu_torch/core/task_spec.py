"""Task/actor specs that travel over the wire.

Parity with the reference's TaskSpecification (`src/ray/
common/task/task_spec.h`) minus protobuf: a python dataclass pickled by the
RPC layer. Small args are inlined in the spec; large args are put in the
object store by the submitter and referenced
(ref: `_raylet.pyx:392-497`, `ray_config_def.h:210`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

NORMAL_TASK = "task"
ACTOR_CREATION = "actor_creation"
ACTOR_TASK = "actor_task"


@dataclass
class ArgSpec:
    kind: str                      # "value" | "ref"
    value: bytes | None = None     # serialized (pack) when kind == "value"
    object_id: bytes | None = None  # when kind == "ref"
    owner_address: tuple[str, int] | None = None


@dataclass
class TaskSpec:
    kind: str
    task_id: bytes
    job_id: bytes
    name: str                           # human-readable fn/method name
    fn_blob: bytes | None               # cloudpickled callable (task / actor cls)
    args: list[ArgSpec] = field(default_factory=list)
    kwargs_keys: list[str] = field(default_factory=list)  # trailing args are kwargs
    num_returns: int = 1
    # num_returns="dynamic": the task body is a generator; each yielded item
    # is stored as its own object and the single return resolves to the list
    # of their refs (ref: _raylet.pyx:602 dynamic generator returns).
    dynamic_returns: bool = False
    return_ids: list[bytes] = field(default_factory=list)
    resources: dict[str, float] = field(default_factory=dict)
    hold_resources: dict[str, float] | None = None  # actor lifetime holdings
    max_retries: int = 0
    retry_count: int = 0
    # actor fields
    actor_id: bytes | None = None
    method_name: str | None = None
    seq_no: int = -1                    # per-(caller, actor) ordering
    max_restarts: int = 0
    max_concurrency: int = 1
    actor_name: str | None = None
    # named concurrency group this actor call executes in (ref:
    # transport/concurrency_group_manager.cc); None = default pool
    concurrency_group: str | None = None
    # {"group": max_concurrency} declared at actor creation
    concurrency_groups: dict[str, int] | None = None
    # owner (submitter) — answers "who owns the returns"
    owner_address: tuple[str, int] | None = None
    # scheduling
    scheduling_strategy: Any = None     # None | "SPREAD" | NodeAffinity(...)
    placement_group_id: bytes | None = None
    placement_group_bundle_index: int = -1
    runtime_env: dict | None = None
    # Distributed-tracing carrier captured at .remote() time (tracing.py:
    # trace_id / span_id / parent_span_id / baggage / submitted_at). The
    # executing worker restores it as the ambient context so nested
    # submissions chain, and stamps the per-hop timing breakdown back into
    # it for the task's profiling span. None = untraced submission.
    trace_ctx: dict | None = None
