"""Ops layer of the port: state API, job submission (+REST), dashboard,
CLI, remote debugger.

Mirrors ``tests/test_ops_layer.py`` test for test on the port's runtime
(``ray_tpu_torch.state``, ``job_submission``, ``dashboard`` and
``python -m ray_tpu_torch``), on one module-scoped cluster, then
``tests/test_observability.py``'s dashboard and debugger cases
(`test_dashboard_metrics_endpoint`, `TestRemoteDebugger`,
`TestDashboardUiAndLogs`), and the port's own: every other endpoint of
the dashboard, the CLI's head lifecycle (``start --head`` → ``job`` →
``status`` → ``stop``, which leaves no process and no arena), ``up``
and ``debug``. Tolerance: exact (statuses, counts and strings).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch.job_submission import JobSubmissionClient

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def dash(cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    d = start_dashboard(port=0)
    yield d
    d.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode())


def _gcs_address() -> str:
    from ray_tpu_torch import api

    gcs = api._ensure_client().gcs_address
    return f"{gcs[0]}:{gcs[1]}"


def _cli(*args, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *args], cwd=str(ROOT),
        capture_output=True, text=True, timeout=timeout,
        env=None if env is None else {**os.environ, **env})


# ------------------------------------------------ tests/test_ops_layer.py


class TestStateApi:
    def test_list_nodes(self, cluster):
        nodes = state.list_nodes()
        assert len(nodes) == 1
        n = nodes[0]
        assert n["alive"] and n["resources_total"]["CPU"] == 4

    def test_list_actors_sees_new_actor(self, cluster):
        @ray_tpu_torch.remote
        class Marker:
            def ping(self):
                return "pong"

        a = Marker.options(name="state_marker").remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
        actors = state.list_actors(state="ALIVE")
        assert any(r.get("name") == "state_marker" for r in actors), actors
        ray_tpu_torch.kill(a)

    def test_object_store_stats(self, cluster):
        import numpy as np

        ref = ray_tpu_torch.put(np.zeros(100_000))
        stats = state.object_store_stats()
        assert stats and stats[0]["shm_bytes"] > 0
        assert stats[0]["native_allocator"] is True
        del ref

    def test_cluster_status(self, cluster):
        s = state.cluster_status()
        assert s["nodes_alive"] == 1
        assert s["resources_total"]["CPU"] == 4


class TestJobs:
    def test_submit_and_wait(self, cluster):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
        status = client.wait_until_finished(job_id, timeout=120)
        assert status == "SUCCEEDED"
        assert "job ran ok" in client.get_job_logs(job_id)

    def test_failed_job_status(self, cluster):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
        assert client.wait_until_finished(job_id, timeout=120) == "FAILED"
        assert client.get_job_info(job_id)["return_code"] == 3

    def test_job_driver_attaches_to_cluster(self, cluster):
        """The entrypoint's ray_tpu_torch.init() must attach to THIS
        cluster (via RAY_TPU_TORCH_ADDRESS), not boot a private one."""
        client = JobSubmissionClient()
        script = (
            "import ray_tpu_torch; ray_tpu_torch.init(); "
            "print('CPUS', float(ray_tpu_torch.cluster_resources()"
            ".get('CPU')))"
        )
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"{script}\"")
        assert client.wait_until_finished(job_id, timeout=180) == "SUCCEEDED"
        assert "CPUS 4.0" in client.get_job_logs(job_id)

    def test_stop_job(self, cluster):
        client = JobSubmissionClient()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
        time.sleep(1.0)
        assert client.stop_job(job_id)
        assert client.wait_until_finished(job_id, timeout=60) == "STOPPED"


class TestDashboard:
    def test_endpoints_and_rest_jobs(self, dash):
        s = _get(dash.url + "/api/cluster_status")
        assert s["nodes_alive"] == 1
        assert len(_get(dash.url + "/api/nodes")) == 1
        assert isinstance(_get(dash.url + "/api/actors"), list)
        assert _get(dash.url + "/api/memory")[0]["capacity"] > 0

        # REST job submission through the JobSubmissionClient facade.
        client = JobSubmissionClient(dash.url)
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('rest job')\"")
        assert client.wait_until_finished(job_id, timeout=120) == "SUCCEEDED"
        assert "rest job" in client.get_job_logs(job_id)
        assert any(j["job_id"] == job_id for j in client.list_jobs())


class TestCli:
    def test_status_and_list_against_running_cluster(self, cluster):
        addr = _gcs_address()
        out = _cli("status", "--address", addr)
        assert out.returncode == 0, out.stderr
        assert "nodes: 1 alive" in out.stdout
        out = _cli("list", "nodes", "--address", addr)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)[0]["alive"] is True


# ---------------------------------- tests/test_observability.py's cases


def test_dashboard_metrics_endpoint(dash):
    with urllib.request.urlopen(dash.url + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        r.read()


def test_rpdb_set_trace_attach_continue(cluster):
    """A task parks at rpdb.set_trace(); we list the breakpoint, attach
    over TCP, and send `c`: the task resumes and completes."""
    from ray_tpu_torch.utils import rpdb

    @ray_tpu_torch.remote(max_retries=0)
    def buggy():
        x = 41
        rpdb.set_trace(timeout_s=60)
        return x + 1

    ref = buggy.remote()
    deadline = time.monotonic() + 60
    bps = []
    while time.monotonic() < deadline and not bps:
        bps = rpdb.list_breakpoints()
        time.sleep(0.2)
    assert bps, "breakpoint never registered"
    bp = bps[0]
    assert bp["function"] == "buggy"
    sock = socket.create_connection((bp["host"], bp["port"]), timeout=30)
    f = sock.makefile("rw", encoding="utf-8", newline="\n")
    banner = f.readline()
    assert "ray_tpu_torch rpdb" in banner
    sock.sendall(b"p x\n")
    time.sleep(0.5)
    sock.sendall(b"c\n")
    sock.close()
    assert ray_tpu_torch.get(ref, timeout=60) == 42
    assert rpdb.list_breakpoints() == []


def test_ui_page_and_log_fetch_api(dash):
    """The page at / names the port; the per-node worker logs list and a
    log tail fetch over HTTP."""
    @ray_tpu_torch.remote
    def noisy():
        print("dashboard-log-marker-xyz", flush=True)
        return 1

    assert ray_tpu_torch.get(noisy.remote(), timeout=60) == 1
    time.sleep(1.0)
    with urllib.request.urlopen(dash.url + "/", timeout=30) as r:
        page = r.read().decode()
    assert "<title>ray_tpu_torch dashboard (PyTorch/CUDA port)</title>" in page
    assert "/api/logs" in page
    logs = _get(dash.url + "/api/logs")
    node_id, files = next((k, v) for k, v in logs.items() if v)
    worker_logs = [f for f in files if f["name"].startswith("worker-")]
    assert worker_logs, files
    found = any(
        "dashboard-log-marker-xyz" in _get(
            f"{dash.url}/api/logs/{node_id}/{f['name']}").get("data", "")
        for f in worker_logs)
    assert found, "marker not found in any worker log tail"


# ------------------------------------------------------- the port's own


def test_every_other_endpoint_serves(dash):
    """The endpoints the JAX tests read in other files, here without a
    serve controller: timeline, traces (and a 404 for an unknown one),
    events, series, autoscale (mode off), slo, the serve REST mirror and
    load, and unknown paths (404)."""
    assert isinstance(_get(dash.url + "/api/timeline"), list)
    assert isinstance(_get(dash.url + "/api/traces"), list)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(dash.url + "/api/traces/" + "f" * 32,
                               timeout=30)
    assert err.value.code == 404
    assert isinstance(_get(dash.url + "/api/events"), list)
    assert _get(dash.url + "/api/series?name=nothing_here&window_s=10") == {
        "series": []}
    assert _get(dash.url + "/api/autoscale") == {"mode": "off",
                                                  "deployments": {}}
    slo = _get(dash.url + "/api/slo")["objectives"]
    assert {"llm_ttft_p95", "http_request_p95"} <= {o["name"] for o in slo}
    assert _get(dash.url + "/api/serve/load") == {"deployments": {}}
    assert "applications" in _get(dash.url + "/api/serve/applications")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(dash.url + "/api/nowhere", timeout=30)
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(dash.url + "/api/jobs/nosuchjob", timeout=30)
    assert err.value.code == 404


def test_cli_debug_without_breakpoints(cluster):
    out = _cli("debug", "--address", _gcs_address())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no active breakpoints"


def test_cli_help_names_the_port():
    out = _cli("start", "--help")
    assert out.returncode == 0
    assert out.stdout.startswith("usage: ray_tpu_torch start")
    assert '{"GPU": 1}' in out.stdout


def _descendants(root: int) -> list[int]:
    """Every live process below ``root``."""
    kids: dict[int, list[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    out, todo = [], [root]
    while todo:
        for k in kids.get(todo.pop(), []):
            out.append(k)
            todo.append(k)
    return out


def _cmdline(pid: int) -> bytes:
    try:
        return Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return b""


def test_cli_head_lifecycle(tmp_path):
    """``start --head`` with a GPU resource and the dashboard, then a job
    through ``job submit --wait`` read back by ``job status``/``logs``
    and the dashboard, ``status``, and ``stop``: the head exits, its
    record goes, and none of its processes nor its raylet's arena is
    left."""
    env = {"RAY_TPU_TORCH_STATE_DIR": str(tmp_path / "state")}
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--num-cpus", "2", "--resources", '{"GPU": 1}',
         "--dashboard-port", "0"], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **env})
    try:
        lines = {}
        while "dashboard" not in lines:
            line = head.stdout.readline()
            assert line, "head exited before its dashboard started"
            if line.startswith("head started; GCS at "):
                lines["gcs"] = line.split()[-1]
            elif line.startswith("dashboard at "):
                lines["dashboard"] = line.split()[-1]
        record = json.loads((tmp_path / "state" / "head.json").read_text())
        assert record["pid"] == head.pid
        assert record["gcs_address"] == lines["gcs"]
        out = _cli("job", "submit", "--wait", "--", sys.executable, "-c",
                   "print('lifecycle job')", env=env)
        assert out.returncode == 0, out.stderr
        job_id = out.stdout.splitlines()[0]
        assert "lifecycle job" in out.stdout
        out = _cli("job", "status", job_id, env=env)
        assert out.stdout.strip() == "SUCCEEDED"
        out = _cli("job", "logs", job_id, env=env)
        assert out.stdout == "lifecycle job\n"
        info = _get(f"{lines['dashboard']}/api/jobs/{job_id}")
        assert info["status"] == "SUCCEEDED"
        assert _get(f"{lines['dashboard']}/api/jobs/{job_id}/logs") == {
            "logs": "lifecycle job\n"}
        s = _get(lines["dashboard"] + "/api/cluster_status")
        assert s["resources_total"] == {"CPU": 2.0, "GPU": 1.0}
        out = _cli("status", env=env)
        assert "nodes: 1 alive" in out.stdout and "GPU: 1/1" in out.stdout
        procs = _descendants(head.pid)
        raylets = [p for p in procs
                   if b"ray_tpu_torch.core.raylet" in _cmdline(p)]
        assert len(raylets) == 1 and len(procs) >= 3, procs
        arenas = [n for n in os.listdir("/dev/shm")      # named by its pid
                  if n.startswith("raytpu-torch-arena-")
                  and n.endswith(f"-{raylets[0]}")]
        assert len(arenas) == 1, arenas
        out = _cli("stop", env=env)
        assert out.stdout.strip() == f"sent SIGTERM to head pid {head.pid}"
        assert head.wait(timeout=60) == 0
    finally:
        if head.poll() is None:
            head.send_signal(signal.SIGKILL)
            head.wait()
    assert not (tmp_path / "state" / "head.json").exists()
    assert not os.path.exists(f"/dev/shm/{arenas[0]}"), \
        "the head's arena is left in /dev/shm"
    deadline = time.monotonic() + 10
    while [p for p in procs if _cmdline(p)] and time.monotonic() < deadline:
        time.sleep(0.2)
    assert [p for p in procs if _cmdline(p)] == [], "processes left"


def test_cli_up_starts_a_head_and_its_autoscaler(tmp_path):
    """``up`` on a local-provider YAML with ``min_workers`` 1 prints the
    address JSON; a driver attached there sees the head and the node the
    autoscaler launched (labelled with its provider id); SIGTERM tears
    both down and leaves no raylet."""
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text("cluster_name: cli-up\nprovider: {type: local}\n"
                   "head_resources: {CPU: 1}\nnode_types:\n"
                   "  small: {resources: {CPU: 1}, min_workers: 1,"
                   " max_workers: 1}\n")
    up = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "up", str(cfg)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = up.stdout.readline()
        assert line, up.stderr.read()[-3000:]
        info = json.loads(line)
        assert info["cluster_name"] == "cli-up"
        driver = (
            "import json, time, ray_tpu_torch as rt\n"
            f"rt.init(address={info['address']!r})\n"
            "deadline = time.monotonic() + 60\n"
            "while time.monotonic() < deadline:\n"
            "    alive = [n for n in rt.nodes() if n['Alive']]\n"
            "    if len(alive) >= 2: break\n"
            "    time.sleep(0.5)\n"
            "print(json.dumps([n['Labels'] for n in alive]))\n"
            "rt.shutdown()\n")
        out = subprocess.run([sys.executable, "-c", driver], cwd=str(ROOT),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        labels = json.loads(out.stdout.splitlines()[-1])
        assert len(labels) == 2, labels
        assert sum("provider_node_id" in lb for lb in labels) == 1, labels
        procs = _descendants(up.pid)
        raylets = [p for p in procs
                   if b"ray_tpu_torch.core.raylet" in _cmdline(p)]
        assert len(raylets) == 2, procs     # the head's and the node's
        up.send_signal(signal.SIGTERM)
        assert up.wait(timeout=60) == 0, up.stderr.read()[-3000:]
    finally:
        if up.poll() is None:
            up.send_signal(signal.SIGKILL)
            up.wait()
    deadline = time.monotonic() + 10
    while [p for p in procs if _cmdline(p)] and time.monotonic() < deadline:
        time.sleep(0.2)
    assert [p for p in procs if _cmdline(p)] == [], "processes left"
