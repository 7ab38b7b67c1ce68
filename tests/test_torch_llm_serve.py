"""The port's LLMDeployment on the port's cluster, against the JAX engine.

- ``TestSliceAgainstJax``: the tiny model in fp32 with the JAX
  package's weights (``jax.random.key(42)``), carried over by
  ``ray_tpu_torch._bridge.params_from_jax`` into a port `Checkpoint`
  directory, served by ``LLMDeployment(device="cpu",
  params_checkpoint=...)`` replicas of the port's serve plane. Their
  greedy streams equal, token for token, the JAX `LLMEngine`'s run in
  process on the same weights and knobs, through
  ``handle.method("generate")``, ``handle.stream`` and the proxy's SSE;
  and through a prefill→decode pool split over the cluster store
  (`kv_objects.ObjectKVStore`), where the decode replica adopts once
  per handoff with no adoption failure and the page accounting closes
  on both replicas. Exact equality (token ids and counts); no float
  tolerance is involved.
- ``TestServeIntegration``: mirrors
  ``tests/test_llm_serve.py::TestServeIntegration`` (2 cases) with
  ``device="cpu"`` in place of ``jax_platform="cpu"``; its only timing
  assertion is the JAX test's own, the first token before half the
  stream.
"""

import json
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import profiling
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train.checkpoint import Checkpoint

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

JCFG = jgpt.GPTConfig.tiny(attn_impl="xla", dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
KNOBS = {"kv_mode": "paged", "page_size": 16, "prefill_chunk": 16,
         "prefill_token_budget": 64, "decode_block": 4}
SHAPE = {"n_slots": 4, "max_len": 256}
MAX_TOKENS = 12


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, JCFG.vocab_size, n)))
            for n in lengths]


def _handoffs() -> float:
    return sum(r["value"] for r in profiling.metrics_snapshot()
               if r["name"] == "serve_handoffs_total")


class TestSliceAgainstJax:
    # Every prompt holds at least one full chunk, so each handoff has
    # pages to adopt.
    PROMPTS = _prompts(11, (20, 33, 47, 16, 64, 29))

    @pytest.fixture(scope="class")
    def stack(self, tmp_path_factory):
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.llm import LLMDeployment

        jp = jgpt.init_params(JCFG, jax.random.key(42))
        jeng = JaxEngine(JCFG, jp, **SHAPE, **KNOBS)
        expected = []
        for p in self.PROMPTS:
            req = jeng.submit(p, max_tokens=MAX_TOKENS)
            while not req.done.is_set():
                jeng.step()
            expected.append(list(req.out_ids))
        tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             TCFG, device="cpu")
        ckpt = Checkpoint.from_params(tp).to_directory(
            str(tmp_path_factory.mktemp("tiny_fp32_ckpt")))
        ray_tpu_torch.init(num_cpus=6)
        try:
            common = dict(device="cpu", params_checkpoint=ckpt, **SHAPE)
            serve.run(serve.deployment(LLMDeployment, name="fused").options(
                num_replicas=1, route_prefix="/fused").bind(
                TCFG, engine_kwargs=dict(KNOBS), **common), timeout=300.0)
            serve.run(serve.deployment(
                LLMDeployment, name="kvd", pool_role="decode").options(
                num_replicas=1, route_prefix=None).bind(
                TCFG, pool_role="decode", engine_kwargs=dict(KNOBS),
                **common), timeout=300.0)
            serve.run(serve.deployment(
                LLMDeployment, name="kvp", pool_role="prefill").options(
                num_replicas=1, route_prefix="/kv").bind(
                TCFG, pool_role="prefill", pool_peer="kvd",
                engine_kwargs=dict(KNOBS), **common), timeout=300.0)
            _proxy, port = serve.start_proxy()
            yield {"expected": expected, "port": port}
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def test_generate_equals_jax_engine(self, stack):
        from ray_tpu_torch import serve

        h = serve.get_deployment_handle("fused")
        got = [ray_tpu_torch.get(h.method("generate", p,
                                          max_tokens=MAX_TOKENS),
                                 timeout=120)["output_ids"]
               for p in self.PROMPTS]
        assert got == stack["expected"]

    def test_stream_equals_jax_engine(self, stack):
        from ray_tpu_torch import serve

        h = serve.get_deployment_handle("fused")
        got = [list(h.stream({"prompt_ids": p, "max_tokens": MAX_TOKENS}))
               for p in self.PROMPTS]
        assert got == stack["expected"]

    def test_sse_equals_jax_engine(self, stack):
        import bench_chaos

        got = []
        for p in self.PROMPTS:
            r = bench_chaos._sse_stream(stack["port"], "/fused", {
                "prompt_ids": p, "max_tokens": MAX_TOKENS}, timeout_s=120)
            assert r["error"] is None and r["done"], r
            got.append(r["tokens"])
        assert got == stack["expected"]

    def test_pool_split_over_the_cluster_store(self, stack):
        """Half the prompts through the prefill pool's handle stream,
        half through the proxy's SSE: every stream equals the JAX
        engine's, the decode replica adopted once per handoff (none
        failed, none re-prefilled from token ids), and the page
        accounting closes on both replicas once they are quiet."""
        import bench_chaos
        from ray_tpu_torch import serve

        kvp = serve.get_deployment_handle("kvp")
        kvd = serve.get_deployment_handle("kvd")
        before = ray_tpu_torch.get(kvd.method("metrics"), timeout=60)
        h0 = _handoffs()
        got = []
        for i, p in enumerate(self.PROMPTS):
            payload = {"prompt_ids": p, "max_tokens": MAX_TOKENS}
            if i % 2 == 0:
                got.append(list(kvp.stream(payload)))
            else:
                r = bench_chaos._sse_stream(stack["port"], "/kv", payload,
                                            timeout_s=120)
                assert r["error"] is None and r["done"], r
                got.append(r["tokens"])
        assert got == stack["expected"]
        # The driver's handle counted its own handoffs (the proxy's
        # count lives in the proxy's process).
        assert _handoffs() - h0 == len(self.PROMPTS[::2])
        after = ray_tpu_torch.get(kvd.method("metrics"), timeout=60)
        delta = {k: after[k] - before[k] for k in (
            "kv_adoptions", "kv_adopt_failures", "kv_partial_adoptions")}
        assert delta == {"kv_adoptions": len(self.PROMPTS),
                         "kv_adopt_failures": 0,
                         "kv_partial_adoptions": 0}, delta
        for h in (kvp, kvd):
            acc = ray_tpu_torch.get(h.method("page_accounting"), timeout=60)
            assert acc["closure"] and acc["refs_consistent"], acc
        # The page sets went through the cluster store: its GCS index
        # holds the donated chain's digests, each naming an object.
        from ray_tpu_torch import api as tapi
        from ray_tpu_torch.serve.kv_objects import INDEX_NS

        rows = [json.loads(tapi._client.kv_get(INDEX_NS, k))
                for k in tapi._client.kv_keys(INDEX_NS)]
        assert rows and all(r.get("ref") for r in rows)


class TestServeIntegration:
    @pytest.fixture(scope="class")
    def cluster(self):
        """One cluster for the class; each test shuts its serve app down."""
        ray_tpu_torch.init(num_cpus=4)
        yield
        ray_tpu_torch.shutdown()

    def test_llm_deployment_parallel_requests(self, cluster):
        from ray_tpu_torch import serve

        try:
            from ray_tpu_torch.serve.llm import LLMDeployment

            dep = serve.deployment(LLMDeployment, name="llm").options(
                num_replicas=1).bind(
                "tiny", n_slots=4, max_len=64, device="cpu",
                engine_kwargs={"prefill_buckets": (8, 16)})
            handle = serve.run(dep)
            refs = [
                handle.method("generate", [5 + i, 9], max_tokens=4)
                for i in range(6)
            ]
            outs = ray_tpu_torch.get(refs, timeout=180)
            assert all(len(o["output_ids"]) == 4 for o in outs)
            assert all(o["ttft_s"] > 0 for o in outs)
            m = ray_tpu_torch.get(handle.method("metrics"), timeout=60)
            assert m["completed"] >= 6
            # Per-request TTFT/decode histograms flush from the replica's
            # worker to the cluster metrics hub in histogram exposition.
            from ray_tpu_torch import state as _state

            deadline = time.time() + 30
            text = ""
            while time.time() < deadline:
                text = _state.prometheus_metrics()
                if "serve_llm_ttft_s_bucket" in text:
                    break
                time.sleep(0.5)
            assert "serve_llm_ttft_s_bucket" in text
            assert "serve_llm_ttft_s_count" in text
            assert "serve_llm_decode_tok_s_bucket" in text
        finally:
            serve.shutdown()

    def test_streaming_handle_and_http_sse(self, cluster):
        """Clients see tokens BEFORE generation completes, via
        DeploymentHandle.stream and via the HTTP proxy's SSE path (the
        first data event arrives well before [DONE])."""
        from ray_tpu_torch import serve

        try:
            from ray_tpu_torch.serve.llm import LLMDeployment

            dep = serve.deployment(LLMDeployment, name="llmstream").options(
                num_replicas=1, route_prefix="/llm").bind(
                "tiny", n_slots=4, max_len=512, device="cpu",
                engine_kwargs={"prefill_buckets": (8, 16)})
            handle = serve.run(dep)

            # Warm the generate and the stream paths first: the timing
            # assertions below measure streaming, not first-call costs.
            ray_tpu_torch.get(handle.method(
                "generate", [5, 9, 2], max_tokens=4), timeout=300)
            for _ in handle.stream(
                    {"prompt_ids": [5, 9, 2], "max_tokens": 3}):
                pass

            # --- handle streaming: tokens arrive incrementally
            arrivals = []
            toks = []
            t0 = time.perf_counter()
            for tok in handle.stream(
                    {"prompt_ids": [5, 9, 2], "max_tokens": 64}):
                arrivals.append(time.perf_counter() - t0)
                toks.append(tok)
            assert len(toks) == 64
            # First token must land in a fraction of total stream time.
            assert arrivals[0] < arrivals[-1] * 0.5, (
                f"first token at {arrivals[0]:.3f}s vs last "
                f"{arrivals[-1]:.3f}s — stream was buffered")

            # --- HTTP SSE through the proxy
            from ray_tpu_torch.serve.http_proxy import start_proxy

            _proxy, port = start_proxy()
            time.sleep(1.0)  # route table refresh
            body = json.dumps({"prompt_ids": [5, 9, 2],
                               "max_tokens": 64, "stream": True}).encode()
            req = (b"POST /llm HTTP/1.1\r\nHost: x\r\n"
                   b"Content-Type: application/json\r\n"
                   b"Content-Length: " + str(len(body)).encode() +
                   b"\r\n\r\n" + body)
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as s:
                s.sendall(req)
                s.settimeout(120)
                chunks = []           # (t, bytes)
                buf = b""
                t0 = time.perf_counter()
                while b"data: [DONE]" not in buf:
                    data = s.recv(4096)
                    if not data:
                        break
                    chunks.append((time.perf_counter() - t0, data))
                    buf += data
            assert b"data: [DONE]" in buf, buf[-200:]
            n_tokens = buf.count(b'data: {"token"')
            assert n_tokens == 64, f"got {n_tokens} token events"
            t_first = next(t for t, d in chunks if b"data: {" in d)
            t_done = chunks[-1][0]
            assert t_first < t_done * 0.5, (
                f"first SSE bytes at {t_first:.3f}s vs done {t_done:.3f}s "
                "— the proxy buffered the response")
        finally:
            serve.shutdown()
