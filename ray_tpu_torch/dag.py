"""Lazy task DAGs: ``fn.bind(...)`` builds a graph, executed later.

Parity: `python/ray/dag/` — `DAGNode` (`dag/dag_node.py`),
function nodes built by `.bind()`, `InputNode` for runtime parameters.
Consumed by the workflow engine (durable execution) and usable directly via
``node.execute()`` (each node becomes a task; edges become ObjectRefs).
"""

from __future__ import annotations

import itertools
from typing import Any

_counter = itertools.count()


class DAGNode:
    """A node in a lazy computation graph."""

    def __init__(self):
        self._id = next(_counter)

    def execute(self, *input_args, **input_kwargs):
        """Eagerly execute the DAG rooted here via remote tasks; returns the
        root's ObjectRef."""
        import ray_tpu_torch

        cache: dict[int, Any] = {}

        def submit(node):
            if node._id in cache:
                return cache[node._id]
            if isinstance(node, InputNode):
                raise ValueError("InputNode must be bound via input args")
            if isinstance(node, InputAttributeNode):
                base = node._key
                val = (input_kwargs[base] if isinstance(base, str)
                       else input_args[base])
                cache[node._id] = val
                return val
            assert isinstance(node, FunctionNode), node
            args = [submit(a) if isinstance(a, DAGNode) else a
                    for a in node._args]
            kwargs = {k: submit(v) if isinstance(v, DAGNode) else v
                      for k, v in node._kwargs.items()}
            ref = node._fn.options(**node._options).remote(*args, **kwargs) \
                if node._options else node._fn.remote(*args, **kwargs)
            cache[node._id] = ref
            return ref

        return submit(self)

    def upstream(self) -> "list[DAGNode]":
        return []


class FunctionNode(DAGNode):
    """`fn.bind(*args)` — args may contain other DAG nodes (data edges)."""

    def __init__(self, fn, args: tuple, kwargs: dict, options: dict | None = None):
        super().__init__()
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._options = options or {}
        self._name = getattr(fn, "__name__", "fn")

    def options(self, **opts) -> "FunctionNode":
        return FunctionNode(self._fn, self._args, self._kwargs,
                            {**self._options, **opts})

    def upstream(self) -> list[DAGNode]:
        out = [a for a in self._args if isinstance(a, DAGNode)]
        out += [v for v in self._kwargs.values() if isinstance(v, DAGNode)]
        return out

    def __repr__(self):
        return f"FunctionNode({self._name}#{self._id})"


class InputNode(DAGNode):
    """Placeholder for runtime input. Index/attribute access produces
    `InputAttributeNode`s bound at execute() time.

    with InputNode() as inp:
        dag = f.bind(inp[0], inp.x)
    dag.execute(3, x=4)
    """

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key: int) -> "InputAttributeNode":
        return InputAttributeNode(key)

    def __getattr__(self, key: str) -> "InputAttributeNode":
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(key)


class InputAttributeNode(DAGNode):
    def __init__(self, key):
        super().__init__()
        self._key = key

    def __repr__(self):
        return f"InputAttributeNode({self._key!r})"


def topological_order(root: DAGNode) -> list[DAGNode]:
    """Upstream-first ordering of the DAG rooted at `root`."""
    seen: dict[int, DAGNode] = {}
    order: list[DAGNode] = []

    def visit(n: DAGNode):
        if n._id in seen:
            return
        seen[n._id] = n
        for u in n.upstream():
            visit(u)
        order.append(n)

    visit(root)
    return order
