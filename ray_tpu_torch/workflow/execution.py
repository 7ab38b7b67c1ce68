"""Workflow executor: durable, resumable DAG runs on top of tasks.

Counterpart of ``ray_tpu/workflow/execution.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/workflow/workflow_executor.py` +
`step_executor.py` — each DAG node is executed as a task; every completed
step's output is checkpointed through WorkflowStorage before downstream
steps consume it; a continuation (a step returning another DAG) extends the
workflow; resume replays only missing steps.

Step identity: deterministic from the DAG topology — `name_<k>` where k is
the node's index in a stable topological order — so a resumed run (same
spec) maps steps onto the prior run's checkpoints.
"""

from __future__ import annotations

import logging
from typing import Any

from ray_tpu_torch.dag import DAGNode, FunctionNode, topological_order
from ray_tpu_torch.workflow.storage import (
    STATUS_FAILED,
    STATUS_RUNNING,
    STATUS_SUCCESSFUL,
    WorkflowStorage,
)

logger = logging.getLogger(__name__)


class Continuation:
    """Returned by a step to extend the workflow with a nested DAG
    (ref: workflow/api.py:712 `continuation`)."""

    def __init__(self, dag: DAGNode):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation() takes a DAG node (fn.bind(...))")
        self.dag = dag


def _step_ids(root: DAGNode, prefix: str = "") -> dict[int, str]:
    order = topological_order(root)
    ids = {}
    for k, node in enumerate(order):
        name = node._name if isinstance(node, FunctionNode) else "input"
        ids[node._id] = f"{prefix}{name}_{k}"
    return ids


def execute_dag(root: DAGNode, store: WorkflowStorage, prefix: str = "") -> Any:
    """Run the DAG; returns the root's final value. Completed steps are
    loaded from storage instead of re-run."""
    import ray_tpu_torch as rt

    ids = _step_ids(root, prefix)
    cache: dict[int, Any] = {}

    def resolve(node: DAGNode) -> Any:
        if node._id in cache:
            return cache[node._id]
        if not isinstance(node, FunctionNode):
            raise TypeError(
                f"workflows execute function DAGs; got {node!r} "
                "(InputNode is not supported in durable workflows — close "
                "over values or pass them to bind())"
            )
        step_id = ids[node._id]
        if store.has_step(step_id):
            value = store.load_step_result(step_id)
            logger.debug("workflow %s: step %s loaded from checkpoint",
                         store.workflow_id, step_id)
        else:
            args = [resolve(a) if isinstance(a, DAGNode) else a
                    for a in node._args]
            kwargs = {k: resolve(v) if isinstance(v, DAGNode) else v
                      for k, v in node._kwargs.items()}
            fn = node._fn.options(**node._options) if node._options else node._fn
            value = rt.get(fn.remote(*args, **kwargs))
            if isinstance(value, Continuation):
                # Durably execute the nested DAG, namespaced under this step.
                value = execute_dag(
                    value.dag, store, prefix=f"{step_id}." )
            store.save_step_result(step_id, value)
        cache[node._id] = value
        return value

    return resolve(root)


def run_workflow(root: DAGNode, store: WorkflowStorage) -> Any:
    store.set_status(STATUS_RUNNING)
    try:
        result = execute_dag(root, store)
    except BaseException as e:
        store.set_status(STATUS_FAILED)
        meta = store.load_meta()
        meta["error"] = repr(e)
        store.save_meta(meta)
        raise
    store.save_step_result("__output__", result)
    store.set_status(STATUS_SUCCESSFUL)
    return result
