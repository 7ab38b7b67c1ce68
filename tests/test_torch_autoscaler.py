"""The port's autoscaler (``ray_tpu_torch/autoscaler``) against the JAX
package's (``ray_tpu/autoscaler``).

- The nine pure cases of ``tests/test_autoscaler.py`` (``TestBinPacking``,
  ``TestReconcile``) run through both packages' ``get_nodes_to_launch``
  and ``StandardAutoscaler.update(view)`` over a ``MockProvider``: the
  plans, the number of launches and the terminations (as indices of the
  nodes the case created) are equal, and equal to the reference's
  expected values.
- ``TestEndToEnd`` and ``test_yaml_up_scales_to_min_workers`` of the
  reference run on the port's runtime (real raylet subprocesses).
- The GCP GPU provider (the twin of the TPU-pod provider) runs against a
  fake ``gcloud`` that logs its arguments: the commands it issues,
  create/list/describe/delete, and the refusal of a node type without an
  accelerator.
- ``load_cluster_config`` without pyyaml raises ``ImportError`` naming
  it; the ``gcp_tpu`` provider type raises naming ``gcp_gpu``.
- The port's own: a task that no live node can run fails at once without
  an autoscaler (the reference's behaviour) and, on an ``up`` cluster
  whose autoscaler can launch a node that fits, waits for that node.
Tolerance: exact.
"""

import json
import stat
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu.autoscaler import autoscaler as j_autoscaler
from ray_tpu.autoscaler import node_provider as j_provider
from ray_tpu_torch.autoscaler import autoscaler as t_autoscaler
from ray_tpu_torch.autoscaler import node_provider as t_provider
from ray_tpu_torch.autoscaler import (
    LocalSubprocessProvider,
    NodeType,
    StandardAutoscaler,
)

PACKAGES = {"jax": (j_autoscaler, j_provider),
            "torch": (t_autoscaler, t_provider)}


def _view(nodes):
    """The reference's ``TestReconcile._view``."""
    return {
        f"n{i}".encode(): {
            "alive": True,
            "resources_total": n["total"],
            "resources_available": n.get("avail", n["total"]),
            "pending_demand": n.get("demand", []),
            "labels": n.get("labels", {}),
        }
        for i, n in enumerate(nodes)
    }


def _types(prov):
    return {"cpu4": prov.NodeType("cpu4", {"CPU": 4.0}, max_workers=5),
            "big": prov.NodeType("big", {"CPU": 16.0}, max_workers=2),
            "cpu4_max2": prov.NodeType("cpu4", {"CPU": 4.0}, max_workers=2),
            "cpu4_min2": prov.NodeType("cpu4", {"CPU": 4.0},
                                       min_workers=2)}


# Bin packing: (demand, free capacities, node type keys) → plan.
PACKING = {
    "demand_fits_existing_capacity": (
        [{"CPU": 1.0}] * 3, [{"CPU": 4.0}], ["cpu4"], {}),
    "unmet_demand_launches_nodes": (
        [{"CPU": 1.0}] * 10, [{"CPU": 1.0}], ["cpu4"], {"cpu4": 3}),
    "max_workers_bounds_launches": (
        [{"CPU": 4.0}] * 10, [], ["cpu4_max2"], {"cpu4": 2}),
    "big_shape_picks_big_node": (
        [{"CPU": 8.0}], [{"CPU": 4.0}], ["cpu4", "big"], {"big": 1}),
    "infeasible_shape_ignored": (
        [{"CPU": 64.0}], [], ["cpu4", "big"], {}),
}


def _packing(case, pkg):
    asc, prov = PACKAGES[pkg]
    demand, free, keys, _ = PACKING[case]
    types = _types(prov)
    return asc.get_nodes_to_launch(demand, free, [types[k] for k in keys],
                                   {})


def _reconcile(case, pkg):
    """One reference reconcile case → (launch counts per update,
    terminations per update as indices into the nodes the case created,
    the provider's node count)."""
    asc_mod, prov = PACKAGES[pkg]
    types = _types(prov)
    provider = prov.MockProvider()
    created = []
    if case == "scale_up_on_demand":
        asc = asc_mod.StandardAutoscaler(provider, [types["cpu4"]],
                                         idle_timeout_s=0.0)
        views = [_view([{"total": {"CPU": 2.0}, "avail": {"CPU": 0.0},
                         "demand": [{"CPU": 1.0}] * 6}])]
    elif case == "min_workers_maintained":
        asc = asc_mod.StandardAutoscaler(provider, [types["cpu4_min2"]])
        views = [_view([])]
    elif case == "idle_scale_down_after_timeout":
        asc = asc_mod.StandardAutoscaler(provider, [types["cpu4"]],
                                         idle_timeout_s=0.2)
        created.append(provider.create_node(types["cpu4"]))
        views = [_view([{"total": {"CPU": 4.0},
                         "labels": {"provider_node_id": created[0]}}])] * 2
    else:
        assert case == "busy_labeled_node_not_terminated"
        asc = asc_mod.StandardAutoscaler(provider, [types["cpu4"]],
                                         idle_timeout_s=0.0)
        created.append(provider.create_node(types["cpu4"]))
        views = [_view([{"total": {"CPU": 4.0}, "avail": {"CPU": 1.0},
                         "labels": {"provider_node_id": created[0]}}])]
    launched, terminated = [], []
    for i, view in enumerate(views):
        if i:
            time.sleep(0.25)   # past the idle timeout
        out = asc.update(view)
        launched.append(len(out["launched"]))
        terminated.append([created.index(n) for n in out["terminated"]])
        assert out["demand"] == sum(len(n["pending_demand"])
                                    for n in view.values())
    return launched, terminated, len(provider.nodes)


RECONCILE = {
    "scale_up_on_demand": ([2], [[]], 2),   # 6 CPU over 2 cpu4 nodes
    "min_workers_maintained": ([2], [[]], 2),
    # The idle timer starts on the first pass; the second terminates.
    "idle_scale_down_after_timeout": ([0, 0], [[], [0]], 0),
    "busy_labeled_node_not_terminated": ([0], [[]], 1),
}


@pytest.mark.parametrize("case", list(PACKING) + list(RECONCILE))
def test_pure_case_equals_the_reference(case):
    run = _packing if case in PACKING else _reconcile
    expected = (PACKING[case][3] if case in PACKING else RECONCILE[case])
    got = {pkg: run(case, pkg) for pkg in PACKAGES}
    assert got["torch"] == got["jax"] == expected, got


def test_node_type_fields_match():
    assert ([f.name for f in t_provider.NodeType.__dataclass_fields__
             .values()] == [f.name for f in j_provider.NodeType
                            .__dataclass_fields__.values()])


def test_autoscaled_node_runs_tasks():
    """The reference's ``TestEndToEnd``: demand on a saturated 1-CPU
    cluster launches a real subprocess node; queued tasks run on it."""
    ray_tpu_torch.init(num_cpus=1)
    provider = None
    try:
        from ray_tpu_torch import api

        gcs = api._ensure_client().gcs_address
        provider = LocalSubprocessProvider(gcs)
        asc = StandardAutoscaler(
            provider, [NodeType("cpu2", {"CPU": 2.0}, max_workers=2)],
            gcs_address=gcs)

        @ray_tpu_torch.remote
        def busy(sec):
            import time as _t

            _t.sleep(sec)
            return 1

        refs = [busy.remote(8)] + [busy.remote(0.1) for _ in range(6)]
        deadline = time.monotonic() + 60
        launched = []
        while time.monotonic() < deadline and not launched:
            time.sleep(1.0)
            launched = asc.update()["launched"]
        assert launched, "autoscaler never launched a node"
        assert ray_tpu_torch.get(refs[1:], timeout=60) == [1] * 6
        provider.terminate_all()
        assert provider.non_terminated_nodes() == []
    finally:
        if provider is not None:
            provider.terminate_all()
        ray_tpu_torch.shutdown()


def test_yaml_up_scales_to_min_workers(tmp_path):
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text("""
cluster_name: yaml-test
provider:
  type: local
head_resources: {CPU: 2}
node_types:
  small:
    resources: {CPU: 2}
    min_workers: 1
    max_workers: 2
""")
    from ray_tpu_torch.autoscaler.yaml_config import up

    cluster = up(str(cfg))
    try:
        ray_tpu_torch.init(address=cluster.address)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len([n for n in ray_tpu_torch.nodes() if n["Alive"]]) >= 2:
                break
            time.sleep(0.5)
        assert len([n for n in ray_tpu_torch.nodes() if n["Alive"]]) >= 2

        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        assert ray_tpu_torch.get(f.remote(41), timeout=120) == 42
    finally:
        ray_tpu_torch.shutdown()
        cluster.down()


def test_a_task_no_node_can_run_waits_for_the_autoscaled_node(tmp_path):
    """A num_gpus=1 task on a head without GPUs: with no autoscaler it
    fails at once, as the reference's; on a cluster whose autoscaler
    advertises a node type with a GPU, its lease queues as demand, the
    autoscaler launches one node, and the task runs there."""
    from ray_tpu_torch.autoscaler.yaml_config import up

    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    ray_tpu_torch.init(num_cpus=1)
    try:
        with pytest.raises(ray_tpu_torch.RayTaskError,
                           match="no node can satisfy"):
            ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(
                where).remote(), timeout=60)
    finally:
        ray_tpu_torch.shutdown()
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text("provider: {type: local}\nhead_resources: {CPU: 1}\n"
                   "node_types:\n  gpu: {resources: {CPU: 1, GPU: 1},"
                   " min_workers: 0, max_workers: 1}\n")
    cluster = up(str(cfg))
    try:
        ray_tpu_torch.init(address=cluster.address)
        node = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(
            where).remote(), timeout=120)
        gpu_nodes = [n["NodeID"] for n in ray_tpu_torch.nodes()
                     if n["Alive"] and n["Labels"].get("provider_node_id")]
        assert gpu_nodes == [node]
        assert len(cluster.provider.non_terminated_nodes()) == 1
    finally:
        ray_tpu_torch.shutdown()
        cluster.down()


def _fake_gcloud(tmp_path):
    """A gcloud that keeps GCE instances in a JSON file and logs every
    argument list."""
    state = tmp_path / "state.json"
    state.write_text("[]")
    log = tmp_path / "calls.jsonl"
    fake = tmp_path / "gcloud"
    fake.write_text(f"""#!{sys.executable} -S
import json, sys
state_path, log_path = {str(state)!r}, {str(log)!r}
args = sys.argv[1:]
with open(log_path, "a") as f:
    f.write(json.dumps(args) + "\\n")
nodes = json.load(open(state_path))
def save():
    json.dump(nodes, open(state_path, "w"))
if "create" in args:
    name = args[args.index("create") + 1]
    nodes.append({{"name": name, "status": "RUNNING"}})
    save()
elif "delete" in args:
    name = args[args.index("delete") + 1]
    nodes[:] = [n for n in nodes if n["name"] != name]
    save()
elif "list" in args:
    print(json.dumps(nodes))
elif "describe" in args:
    name = args[args.index("describe") + 1]
    match = [n for n in nodes if n["name"] == name]
    print(json.dumps(match[0] if match else {{"status": "TERMINATED"}}))
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return fake, log


def test_gcp_gpu_provider_with_fake_gcloud(tmp_path):
    from ray_tpu_torch.autoscaler.gcp_gpu import GcpGpuProvider

    fake, log = _fake_gcloud(tmp_path)
    provider = GcpGpuProvider(
        {"project": "proj", "zone": "us-central1-a",
         "machine_types": {"gpu_worker": "a3-highgpu-8g"}},
        ("10.0.0.1", 6379), gcloud_bin=str(fake))
    nt = NodeType(name="gpu_worker", resources={"CPU": 8, "GPU": 8},
                  labels={"pool": "h100"}, topology="nvidia-h100-80gb:8")
    node_id = provider.create_node(nt)
    assert node_id.startswith("raytpu-torch-")
    assert provider.non_terminated_nodes() == [node_id]
    assert provider.is_ready(node_id)
    assert provider.node_type(node_id) == "gpu_worker"
    provider.terminate_node(node_id)
    assert provider.non_terminated_nodes() == []

    calls = [json.loads(line) for line in log.read_text().splitlines()]
    tail = ["--zone=us-central1-a", "--project=proj"]
    create = calls[0]
    assert create[:4] == ["compute", "instances", "create", node_id]
    assert create[-2:] == tail
    assert "--machine-type=a3-highgpu-8g" in create
    assert "--accelerator=type=nvidia-h100-80gb,count=8" in create
    assert "--maintenance-policy=TERMINATE" in create
    script = create[create.index("--metadata") + 1]
    assert script == (
        "^|^startup-script=python3 -m ray_tpu_torch.core.raylet --gcs "
        "10.0.0.1:6379 --resources '{\"CPU\": 8, \"GPU\": 8}' --labels "
        "'{\"pool\": \"h100\"}'")
    assert calls[1:] == [
        ["compute", "instances", "list", "--format=json", *tail],
        ["compute", "instances", "describe", node_id, "--format=json",
         *tail],
        ["compute", "instances", "delete", node_id, "--quiet", *tail],
        ["compute", "instances", "list", "--format=json", *tail]]


def test_gcp_gpu_refuses_a_node_type_without_an_accelerator(tmp_path):
    from ray_tpu_torch.autoscaler.gcp_gpu import (
        GcpGpuProvider,
        parse_accelerator,
    )

    fake, log = _fake_gcloud(tmp_path)
    provider = GcpGpuProvider({}, ("h", 1), gcloud_bin=str(fake))
    with pytest.raises(ValueError, match="needs `topology`"):
        provider.create_node(NodeType(name="x", resources={"CPU": 1}))
    assert not log.exists()           # refused before any gcloud call
    assert parse_accelerator("nvidia-l4") == ("nvidia-l4", 1)
    with pytest.raises(RuntimeError, match="needs the"):
        GcpGpuProvider({}, ("h", 1), gcloud_bin=str(tmp_path / "none"))


def test_provider_types_and_yaml_without_pyyaml(tmp_path, monkeypatch):
    from ray_tpu_torch.autoscaler import yaml_config
    from ray_tpu_torch.autoscaler.node_provider import MockProvider

    cfg = {"provider": {"type": "gcp_tpu"}, "node_types": {}}
    with pytest.raises(ValueError, match="gcp_gpu"):
        yaml_config.make_provider(cfg, ("h", 1))
    assert isinstance(yaml_config.make_provider(
        {"provider": {"type": "mock"}}, ("h", 1)), MockProvider)
    path = tmp_path / "c.yaml"
    path.write_text("node_types:\n  a: {resources: {CPU: 1}}\n")
    loaded = yaml_config.load_cluster_config(str(path))
    assert loaded["provider"] == {"type": "local"}
    assert [nt.name for nt in yaml_config.parse_node_types(loaded)] == ["a"]
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        yaml_config.load_cluster_config(str(path))
