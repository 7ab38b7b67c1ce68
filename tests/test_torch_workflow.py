"""The port's durable workflows (``ray_tpu_torch/workflow``, on
``ray_tpu_torch/dag.py``) against the JAX package's, case for case.

Each of the ten cases of ``tests/test_workflow.py`` builds the same DAG
under both packages, each on its own module-scoped cluster
(``num_cpus=4``), and runs it through the package's runtime and
workflow API. The results are compared: the outputs, the step ids
(``execution._step_ids`` in topological order), and the stored layout of
each workflow (its files relative to the workflow's root, the keys of
its ``meta.json`` and its status). The reference's own checks hold for
both. Tolerance: exact.
"""

import os
import types

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import dag as j_dag
from ray_tpu import workflow as j_workflow
from ray_tpu.workflow import execution as j_execution
from ray_tpu_torch import dag as t_dag
from ray_tpu_torch import workflow as t_workflow
from ray_tpu_torch.workflow import execution as t_execution

PACKAGES = {"jax": (ray_tpu, j_workflow, j_dag, j_execution),
            "torch": (ray_tpu_torch, t_workflow, t_dag, t_execution)}


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _pkg(name):
    """The package's runtime, workflow API, dag module and executor, with
    the reference's ``add`` and ``mul`` as its remote functions (nested
    functions: the workers take them by value)."""
    rt, wf, dag, ex = PACKAGES[name]

    def add(a, b):
        return a + b

    def mul(a, b):
        return a * b

    return types.SimpleNamespace(rt=rt, wf=wf, dag=dag, ex=ex,
                                 add=rt.remote(add), mul=rt.remote(mul))


def _step_ids(p, root):
    ids = p.ex._step_ids(root)
    return [ids[n._id] for n in p.dag.topological_order(root)]


def _layout(wf_dir, workflow_id):
    """The files under a workflow's root, its meta keys and its status."""
    import json

    root = os.path.join(wf_dir, workflow_id)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    return files, sorted(meta), meta.get("status")


def _both(case, tmp_path):
    """Run ``case(p, wf_dir, scratch)`` under each package, each with its
    own storage and scratch directories. → {package: result}."""
    out = {}
    for name in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        out[name] = case(_pkg(name), str(d / "wf"), d)
    return out


def _equal(case, tmp_path):
    got = _both(case, tmp_path)
    assert got["torch"] == got["jax"], got
    return got["torch"]


# ------------------------------------------------------------ TestDagApi

def test_bind_builds_graph(tmp_path):
    def case(p, _wf_dir, _d):
        dag = p.add.bind(p.add.bind(1, 2), p.mul.bind(2, 3))
        order = p.dag.topological_order(dag)
        assert len(order) == 3 and order[-1] is dag
        return [type(n).__name__ for n in order], _step_ids(p, dag)

    assert _equal(case, tmp_path) == (
        ["FunctionNode"] * 3, ["add_0", "mul_1", "add_2"])


def test_execute_eager(clusters, tmp_path):
    def case(p, _wf_dir, _d):
        dag = p.add.bind(p.add.bind(1, 2), p.mul.bind(2, 3))
        return p.rt.get(dag.execute(), timeout=60)

    assert _equal(case, tmp_path) == 9


def test_input_node(clusters, tmp_path):
    def case(p, _wf_dir, _d):
        with p.dag.InputNode() as inp:
            dag = p.add.bind(inp[0], p.mul.bind(inp.x, 2))
        return p.rt.get(dag.execute(5, x=3), timeout=60)

    assert _equal(case, tmp_path) == 11


def test_diamond_executes_shared_node_once(clusters, tmp_path):
    def case(p, _wf_dir, _d):
        def rand():
            return int(np.random.default_rng().integers(0, 1 << 60))

        shared = p.rt.remote(rand).bind()
        dag = p.add.bind(shared, p.mul.bind(shared, 1))
        v = p.rt.get(dag.execute(), timeout=60)
        return v % 2, _step_ids(p, dag)   # x + x*1 = 2x: sampled once

    assert _equal(case, tmp_path) == (0, ["rand_0", "mul_1", "add_2"])


# -------------------------------------------------------- TestDurableRun

def test_run_and_get_output(clusters, tmp_path):
    def case(p, wf_dir, _d):
        dag = p.add.bind(p.add.bind(1, 2), 3)
        out = p.wf.run(dag, workflow_id="w1", storage_dir=wf_dir)
        assert ("w1", "SUCCESSFUL") in p.wf.list_all(wf_dir)
        return (out, p.wf.get_status("w1", storage_dir=wf_dir),
                p.wf.get_output("w1", storage_dir=wf_dir),
                _step_ids(p, dag), _layout(wf_dir, "w1"))

    out, status, output, ids, layout = _equal(case, tmp_path)
    assert (out, status, output) == (6, "SUCCESSFUL", 6)
    assert ids == ["add_0", "add_1"]
    assert layout == (
        ["dag.pkl", "meta.json", "steps/__output__.pkl", "steps/add_0.pkl",
         "steps/add_1.pkl"],
        ["created_at", "status", "updated_at", "workflow_id"], "SUCCESSFUL")


def test_failure_marks_failed_then_resume_skips_done_steps(clusters,
                                                          tmp_path):
    def case(p, wf_dir, d):
        marker, fail_flag = str(d / "ran_counter"), str(d / "fail")
        open(fail_flag, "w").close()

        def counted(x):
            with open(marker, "a") as f:
                f.write("x")
            return x * 10

        def flaky(x):
            import os

            if os.path.exists(fail_flag):
                raise RuntimeError("injected failure")
            return x + 1

        dag = p.rt.remote(flaky).bind(p.rt.remote(counted).bind(4))
        with pytest.raises(p.rt.api.RayTaskError):
            p.wf.run(dag, workflow_id="w2", storage_dir=wf_dir)
        failed = (p.wf.get_status("w2", storage_dir=wf_dir),
                  _layout(wf_dir, "w2"))
        assert len(open(marker).read()) == 1   # counted checkpointed
        os.unlink(fail_flag)                   # "fix the bug", resume
        out = p.wf.resume("w2", storage_dir=wf_dir)
        assert len(open(marker).read()) == 1   # loaded, not re-run
        return failed, out, _layout(wf_dir, "w2")

    failed, out, layout = _equal(case, tmp_path)
    assert failed == (
        "FAILED", (["dag.pkl", "meta.json", "steps/counted_0.pkl"],
                   ["created_at", "error", "status", "updated_at",
                    "workflow_id"], "FAILED"))
    assert out == 41 and layout[2] == "SUCCESSFUL"
    assert layout[0] == ["dag.pkl", "meta.json", "steps/__output__.pkl",
                         "steps/counted_0.pkl", "steps/flaky_1.pkl"]


def test_resume_successful_workflow_replays_nothing(clusters, tmp_path):
    def case(p, wf_dir, d):
        marker = str(d / "m")

        def counted():
            with open(marker, "a") as f:
                f.write("x")
            return 7

        p.wf.run(p.rt.remote(counted).bind(), workflow_id="w3",
                 storage_dir=wf_dir)
        out = p.wf.resume("w3", storage_dir=wf_dir)
        return out, len(open(marker).read()), _layout(wf_dir, "w3")[0]

    assert _equal(case, tmp_path) == (
        7, 1, ["dag.pkl", "meta.json", "steps/__output__.pkl",
               "steps/counted_0.pkl"])


def test_run_async(clusters, tmp_path):
    def case(p, wf_dir, _d):
        wid = p.wf.run_async(p.add.bind(20, 22), workflow_id="w4",
                             storage_dir=wf_dir)
        return wid, p.wf.get_output(wid, timeout=60, storage_dir=wf_dir)

    assert _equal(case, tmp_path) == ("w4", 42)


def test_continuation(clusters, tmp_path):
    def case(p, wf_dir, _d):
        wf, remote = p.wf, p.rt.remote

        def fib(a, b, n):
            if n == 0:
                return a
            return wf.continuation(fib_r.bind(b, a + b, n - 1))

        fib_r = remote(fib)
        out = wf.run(fib_r.bind(0, 1, 10), workflow_id="w5",
                     storage_dir=wf_dir)
        return out, _layout(wf_dir, "w5")[0]

    out, files = _equal(case, tmp_path)
    assert out == 55
    # Each continuation is namespaced under the step that returned it:
    # the 11 steps of fib(10) nest 1 to 11 deep.
    assert files == sorted(
        ["dag.pkl", "meta.json", "steps/__output__.pkl"]
        + ["steps/" + ".".join(["fib_0"] * k) + ".pkl"
           for k in range(1, 12)])


def test_delete(clusters, tmp_path):
    def case(p, wf_dir, _d):
        p.wf.run(p.add.bind(1, 1), workflow_id="w6", storage_dir=wf_dir)
        before = p.wf.list_all(wf_dir)
        p.wf.delete("w6", storage_dir=wf_dir)
        return before, p.wf.list_all(wf_dir)

    assert _equal(case, tmp_path) == ([("w6", "SUCCESSFUL")], [])


def test_default_base_dir_is_the_ports_own(monkeypatch, tmp_path):
    import tempfile

    from ray_tpu_torch.workflow import storage

    monkeypatch.delenv("RAY_TPU_TORCH_WORKFLOW_DIR", raising=False)
    assert storage.default_base_dir() == os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "workflows")
    monkeypatch.setenv("RAY_TPU_TORCH_WORKFLOW_DIR", str(tmp_path))
    assert storage.default_base_dir() == str(tmp_path)
