"""Serve tests: deployments, routing, batching, HTTP ingress, recovery.

Mirrors `python/ray/serve/tests/` behaviors at small scale.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_function_deployment(cluster):
    @serve.deployment
    def greeter(req):
        return {"hello": req.get("name", "world")}

    handle = serve.run(greeter)
    out = ray_tpu_torch.get(handle.remote({"name": "tpu"}), timeout=60)
    assert out == {"hello": "tpu"}


def test_class_deployment_with_state(cluster):
    @serve.deployment(name="counter_dep")
    class CounterDep:
        def __init__(self, start):
            self.n = start

        def __call__(self, req):
            self.n += 1
            return self.n

    handle = serve.run(CounterDep.bind(100))
    outs = [ray_tpu_torch.get(handle.remote({}), timeout=60) for _ in range(3)]
    assert outs == [101, 102, 103]


def test_multi_replica_routing(cluster):
    @serve.deployment(name="pid_dep", num_replicas=3)
    class PidDep:
        def __call__(self, req):
            import os

            return os.getpid()

    handle = serve.run(PidDep.bind())
    pids = {ray_tpu_torch.get(handle.remote({}), timeout=60) for _ in range(20)}
    assert len(pids) >= 2, f"requests not spread: {pids}"
    assert serve.status()["pid_dep"]["live_replicas"] == 3


def test_redeploy_updates_code(cluster):
    @serve.deployment(name="versioned")
    def v1(req):
        return "v1"

    handle = serve.run(v1)
    assert ray_tpu_torch.get(handle.remote({}), timeout=60) == "v1"

    @serve.deployment(name="versioned")
    def v2(req):
        return "v2"

    handle = serve.run(v2)
    deadline = time.time() + 60
    while time.time() < deadline:
        if ray_tpu_torch.get(handle.remote({}), timeout=60) == "v2":
            break
        time.sleep(0.3)
    assert ray_tpu_torch.get(handle.remote({}), timeout=60) == "v2"


def test_replica_death_recovery(cluster):
    @serve.deployment(name="fragile", num_replicas=1)
    class Fragile:
        def __call__(self, req):
            if req.get("die"):
                import os

                os._exit(1)
            return "alive"

    handle = serve.run(Fragile.bind())
    assert ray_tpu_torch.get(handle.remote({}), timeout=60) == "alive"
    try:
        ray_tpu_torch.get(handle.remote({"die": True}), timeout=30)
    except Exception:
        pass
    # controller reconcile loop should bring a replacement up
    deadline = time.time() + 90
    ok = False
    while time.time() < deadline:
        try:
            if ray_tpu_torch.get(handle.remote({}), timeout=30) == "alive":
                ok = True
                break
        except Exception:
            time.sleep(0.5)
    assert ok, "replica did not recover"


def test_batching(cluster):
    @serve.deployment(name="batched_dep", max_concurrent_queries=16)
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def __call__(self, reqs):
            # list-in/list-out; record observed batch size
            return [{"batch_size": len(reqs), "x": r["x"]} for r in reqs]

    handle = serve.run(Batched.bind())
    refs = [handle.remote({"x": i}) for i in range(8)]
    outs = ray_tpu_torch.get(refs, timeout=120)
    assert sorted(o["x"] for o in outs) == list(range(8))
    assert max(o["batch_size"] for o in outs) >= 2, outs


def test_http_proxy(cluster):
    @serve.deployment(name="http_echo", route_prefix="/echo")
    def echo(req):
        return {"echo": req}

    serve.run(echo)
    _proxy, port = serve.start_proxy()
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            body = json.dumps({"a": 1}).encode()
            r = urllib.request.urlopen(
                urllib.request.Request(
                    f"http://127.0.0.1:{port}/echo",
                    data=body,
                    headers={"Content-Type": "application/json"},
                ),
                timeout=30,
            )
            out = json.loads(r.read())
            assert out == {"result": {"echo": {"a": 1}}}
            break
        except AssertionError:
            raise
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("http proxy never became ready")
    # GET with query params
    r = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/echo?q=5", timeout=30
    )
    assert json.loads(r.read()) == {"result": {"echo": {"q": "5"}}}


def test_delete_deployment(cluster):
    @serve.deployment(name="temp_dep")
    def f(req):
        return 1

    serve.run(f)
    assert "temp_dep" in serve.status()
    serve.delete("temp_dep")
    assert "temp_dep" not in serve.status()


def test_deployment_graph_composition(cluster):
    """Deployment graphs (ref: serve DAG API): a downstream deployment
    bound as an init arg deploys first and arrives as a live handle."""

    @serve.deployment(name="embedder", num_replicas=1)
    class Embedder:
        def __call__(self, text):
            return {"len": len(text)}

    @serve.deployment(name="ranker", num_replicas=1)
    class Ranker:
        def __init__(self, embedder):
            self.embedder = embedder

        def __call__(self, payload):
            emb = ray_tpu_torch.get(self.embedder.remote(payload["text"]))
            return {"score": emb["len"] * 2}

    handle = serve.run(Ranker.bind(Embedder.bind()))
    out = ray_tpu_torch.get(handle.remote({"text": "hello"}), timeout=120)
    assert out == {"score": 10}
    serve.delete("ranker")
    serve.delete("embedder")
