"""Serializability inspection.

Parity: `python/ray/util/check_serialize.py` —
`inspect_serializability` walks closures/attributes of an object that fails
to pickle and reports which inner values are the culprits.
"""

from __future__ import annotations

import inspect
from typing import Any

import cloudpickle


class FailureTuple:
    def __init__(self, obj: Any, name: str, parent: str):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple({self.name!r} in {self.parent!r})"


def _try(obj) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:  # graftlint: disable=EXC-SWALLOW (this IS the serializability probe; failure is the answer)
        return False


def inspect_serializability(
    obj: Any, name: str | None = None, depth: int = 3,
    _parent: str = "<root>", _failures: list | None = None,
) -> tuple[bool, list[FailureTuple]]:
    """→ (serializable, failures). Recurses into closure cells, function
    globals actually referenced, and instance __dict__ to localize what
    can't be pickled."""
    failures = _failures if _failures is not None else []
    name = name or getattr(obj, "__name__", repr(obj)[:40])
    if _try(obj):
        return True, failures
    found_inner = False
    if depth > 0:
        children: list[tuple[str, Any]] = []
        if inspect.isfunction(obj):
            if obj.__closure__:
                children += [
                    (var, cell.cell_contents) for var, cell in
                    zip(obj.__code__.co_freevars, obj.__closure__)
                ]
            children += [
                (g, obj.__globals__[g]) for g in obj.__code__.co_names
                if g in obj.__globals__
            ]
        elif hasattr(obj, "__dict__") and isinstance(obj.__dict__, dict):
            children += list(obj.__dict__.items())
        for child_name, child in children:
            if not _try(child):
                found_inner = True
                inspect_serializability(
                    child, child_name, depth - 1, _parent=name,
                    _failures=failures)
    if not found_inner:
        failures.append(FailureTuple(obj, name, _parent))
    return False, failures


def serialization_error(obj: Any, *, name: str | None = None,
                        kind: str = "object",
                        cause: BaseException | None = None) -> TypeError:
    """Build a TypeError that localizes WHICH inner value failed to pickle.

    The submit path (`.remote()`) calls this when `pack`/`serialize`
    raises: instead of a bare cloudpickle traceback pointing at pickle
    internals, the user sees the culprit chain — the closure cell,
    referenced global, or instance attribute that actually can't cross
    the task boundary. `cause` (the original pickling error) should be
    chained by the caller with `raise ... from cause`.
    """
    name = name or getattr(obj, "__name__", type(obj).__name__)
    try:
        _ok, failures = inspect_serializability(obj, name=name)
    except Exception:  # graftlint: disable=EXC-SWALLOW (diagnosis is best-effort; the original error still propagates via __cause__)
        failures = []
    if failures:
        def _safe_repr(o) -> str:
            # The objects that can't pickle are exactly the ones whose
            # __repr__ tends to blow up too — never let it mask the chain.
            try:
                return repr(o)[:120]
            except Exception:  # graftlint: disable=EXC-SWALLOW (diagnostic formatting must never raise)
                return f"<{type(o).__name__} (repr failed)>"

        chain = "\n".join(
            f"  - {f.name!r} (inside {f.parent!r}): "
            f"{type(f.obj).__name__} = {_safe_repr(f.obj)}"
            for f in failures[:8]
        )
        detail = (f"could not serialize these captured values:\n{chain}\n"
                  "Pass them as arguments, reconstruct them on the worker, "
                  "or drop them from the closure.")
    else:
        detail = (f"could not localize the failing value "
                  f"(original error: {cause!r})")
    return TypeError(f"{kind} {name!r} is not serializable: {detail}")
