"""Durable workflows: crash-resumable DAG execution.

Counterpart of ``ray_tpu/workflow/__init__.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/workflow/api.py` — `run`/`run_async`
(`:120,166`), `resume`, `get_output`, `get_status`, `list_all`,
`continuation` (`:712`). Steps are tasks; outputs are checkpointed to
filesystem storage before downstream consumption, so a killed driver
re-runs only incomplete steps.

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    @rt.remote
    def add(a, b): return a + b

    wf = add.bind(add.bind(1, 2), 3)
    workflow.run(wf, workflow_id="sum")     # → 6
    workflow.resume("sum")                  # replays from checkpoints
"""

from __future__ import annotations

import threading
import uuid
from typing import Any

import cloudpickle

from ray_tpu_torch.dag import DAGNode
from ray_tpu_torch.workflow.execution import Continuation, run_workflow
from ray_tpu_torch.workflow.storage import (
    STATUS_FAILED,
    STATUS_RESUMABLE,
    STATUS_RUNNING,
    STATUS_SUCCESSFUL,
    WorkflowStorage,
    list_workflows,
)

__all__ = [
    "run", "run_async", "resume", "resume_async", "get_output", "get_status",
    "list_all", "continuation", "delete",
]

_async_runs: dict[str, threading.Thread] = {}
_async_results: dict[str, Any] = {}
_async_errors: dict[str, BaseException] = {}


def continuation(dag: DAGNode) -> Continuation:
    """Return from a step to extend the workflow with `dag`."""
    return Continuation(dag)


def run(dag: DAGNode, *, workflow_id: str | None = None,
        storage_dir: str | None = None) -> Any:
    """Execute the DAG durably; blocks until the final result."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
    store = WorkflowStorage(workflow_id, storage_dir)
    store.save_spec(cloudpickle.dumps(dag), {"workflow_id": workflow_id})
    return run_workflow(dag, store)


def run_async(dag: DAGNode, *, workflow_id: str | None = None,
              storage_dir: str | None = None) -> str:
    """Start in a background thread; returns the workflow id (poll with
    get_status / fetch with get_output)."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"

    def target():
        try:
            _async_results[workflow_id] = run(
                dag, workflow_id=workflow_id, storage_dir=storage_dir)
        except BaseException as e:
            _async_errors[workflow_id] = e

    t = threading.Thread(target=target, daemon=True,
                         name=f"workflow-{workflow_id}")
    _async_runs[workflow_id] = t
    t.start()
    return workflow_id


def resume(workflow_id: str, *, storage_dir: str | None = None) -> Any:
    """Re-run a stored workflow; completed steps load from checkpoints."""
    store = WorkflowStorage(workflow_id, storage_dir)
    dag = cloudpickle.loads(store.load_spec())
    return run_workflow(dag, store)


def resume_async(workflow_id: str, *, storage_dir: str | None = None) -> str:
    def target():
        try:
            _async_results[workflow_id] = resume(
                workflow_id, storage_dir=storage_dir)
        except BaseException as e:
            _async_errors[workflow_id] = e

    t = threading.Thread(target=target, daemon=True)
    _async_runs[workflow_id] = t
    t.start()
    return workflow_id


def get_output(workflow_id: str, *, timeout: float | None = None,
               storage_dir: str | None = None) -> Any:
    """Result of a finished (or async-running) workflow."""
    t = _async_runs.get(workflow_id)
    if t is not None:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"workflow {workflow_id} still running")
        if workflow_id in _async_errors:
            raise _async_errors[workflow_id]
        return _async_results[workflow_id]
    store = WorkflowStorage(workflow_id, storage_dir)
    if not store.has_step("__output__"):
        raise ValueError(f"workflow {workflow_id} has no stored output "
                         f"(status={store.status()})")
    return store.load_step_result("__output__")


def get_status(workflow_id: str, *, storage_dir: str | None = None) -> str | None:
    return WorkflowStorage(workflow_id, storage_dir).status()


def list_all(storage_dir: str | None = None) -> list[tuple[str, str | None]]:
    return list_workflows(storage_dir)


def delete(workflow_id: str, *, storage_dir: str | None = None) -> None:
    import shutil

    store = WorkflowStorage(workflow_id, storage_dir)
    shutil.rmtree(store.root, ignore_errors=True)
