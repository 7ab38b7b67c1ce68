"""The port's LLMEngine inside an actor of the port's runtime, and the
engine's global knobs.

- A tiny fp32 port engine on ``device="cpu"`` is built in the
  ``__init__`` of a ``@ray_tpu_torch.remote`` actor, its weights sent
  through the object plane as CPU tensors, every knob from
  ``init(_system_config=...)`` (none passed to the constructor). Its
  greedy streams equal, token for token, the in-process port engine's
  and the JAX engine's with the same knobs given explicitly.
- The actor's request metrics carry the actor id's last 8 hex digits as
  their ``replica`` tag, as the JAX engine's do in an actor.
- The knobs reach the worker's engine through the raylet-forwarded
  config: ``llm_tp=3`` does not divide the 8 heads, so the engine serves
  at tp 1 and logs why in the worker's log.
- The soft-offs of the global knobs, mirrored case for case on both
  engines from each runtime's environment variable:
  tests/test_tp_decode.py::TestKnobValidation::test_global_knob_soft_off
  and ``test_global_knob_misfit_soft_off``, and
  tests/test_kv_objects.py::TestKnobValidation (every case but the Serve
  deployment's, which the port does not have).

The paged kernels' launch counters stay 0 in the driver (their plain
versions run on CPU tensors).
"""

import glob
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.kv_objects import LocalKVStore as JaxKVStore
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import api as tapi
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.kv_objects import LocalKVStore
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(attn_impl="xla", dtype=jnp.float32)   # 8 heads
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
KNOBS = dict(kv_mode="paged", page_size=16, prefill_chunk=16,
             prefill_token_budget=64, decode_block=4)
SYSTEM_CONFIG = {"llm_kv_mode": "paged", "llm_kv_page_size": 16,
                 "llm_prefill_chunk": 16, "llm_prefill_token_budget": 64,
                 "llm_decode_block": 4, "llm_tp": 3}
SHAPE = dict(n_slots=4, max_len=256)
MAX_TOKENS = 8


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, TCFG,
                         device="cpu")
    return jp, tp


def _prompts():
    rng = np.random.default_rng(7)
    return [list(map(int, rng.integers(1, JCFG.vocab_size, n)))
            for n in (5, 17, 33, 40, 9, 24)]


def _drive(eng, prompts):
    reqs = [eng.submit(p, max_tokens=MAX_TOKENS) for p in prompts]
    for _ in range(2000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


@ray_tpu_torch.remote
class EngineActor:
    """A port engine in a worker, built from weights and the runtime's
    config alone."""

    def __init__(self, params):
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.serve.llm import LLMEngine as Engine

        cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
        self.eng = Engine(cfg, params, device="cpu", **SHAPE)

    def serve(self, prompts):
        from ray_tpu_torch import profiling
        from ray_tpu_torch.serve import llm

        reqs = [self.eng.submit(p, max_tokens=MAX_TOKENS) for p in prompts]
        self.eng.start()
        try:
            for r in reqs:
                assert r.done.wait(120), "request did not finish"
        finally:
            self.eng.stop()
        tags = llm._request_metric_tags()
        for r in reqs:
            llm._observe_request_metrics(r, tags)
        replicas = sorted({
            dict(row["tags"]).get("replica")
            for row in profiling.metrics_snapshot()
            if row["name"] == "serve_llm_ttft_s"})
        return {"streams": [r.out_ids for r in reqs],
                "errors": [r.error for r in reqs],
                "actor_id": ray_tpu_torch.get_runtime_context().get_actor_id(),
                "replicas": replicas, "engine_replica": self.eng._replica,
                "closure": self.eng.page_accounting()["closure"]}

    def knobs(self):
        e = self.eng
        return {"kv_mode": e.kv_mode, "page_size": e.page_size,
                "prefill_chunk": e.prefill_chunk,
                "prefill_token_budget": e.prefill_budget,
                "decode_block": e.decode_block, "attn_impl": e.attn_impl,
                "tp": e.tp, "tp_reason": e._tp_disabled_reason}


class TestEngineActor:
    @pytest.fixture(scope="class")
    def actor(self, weights):
        ray_tpu_torch.init(num_cpus=2, _system_config=SYSTEM_CONFIG)
        try:
            yield EngineActor.remote(ray_tpu_torch.put(weights[1]))
        finally:
            ray_tpu_torch.shutdown()

    def test_streams_equal_in_process_and_jax(self, actor, weights):
        prompts = _prompts()
        out = ray_tpu_torch.get(actor.serve.remote(prompts), timeout=180)
        assert out["errors"] == [None] * len(prompts)
        assert out["closure"]
        local = _drive(LLMEngine(TCFG, weights[1], device="cpu", tp=1,
                                 **SHAPE, **KNOBS), prompts)
        ref = _drive(JaxEngine(JCFG, weights[0], **SHAPE, **KNOBS), prompts)
        assert out["streams"] == local == ref
        assert all(len(s) == MAX_TOKENS for s in ref)

    def test_replica_tag_is_the_actor_id_tail(self, actor):
        out = ray_tpu_torch.get(actor.serve.remote(_prompts()[:2]),
                                timeout=180)
        tail = out["actor_id"][-8:]
        assert len(out["actor_id"]) == 24 and out["replicas"] == [tail]
        assert out["engine_replica"] == tail

    def test_system_config_knobs_reach_the_worker_engine(self, actor):
        k = ray_tpu_torch.get(actor.knobs.remote(), timeout=60)
        assert (k["kv_mode"], k["page_size"], k["prefill_chunk"],
                k["prefill_token_budget"], k["decode_block"]) == (
            "paged", 16, 16, 64, 4)
        assert k["attn_impl"] == "gather"        # "auto" on the CPU
        assert k["tp"] == 1
        assert "does not divide the model's n_heads (8)" in k["tp_reason"]
        logs = glob.glob(os.path.join(tapi._node.session_dir, "logs",
                                      "worker-*.log"))
        text = "".join(open(p, errors="replace").read() for p in logs)
        assert "llm_tp soft-disabled to 1" in text


def _jax_engine(params, **kw):
    """tests/test_tp_decode.py's `_engine`."""
    base = dict(n_slots=4, max_len=128, kv_mode="paged", page_size=16,
                prefill_chunk=16, prefill_token_budget=32)
    base.update(kw)
    return JaxEngine(JCFG, params, **base)


def _port_engine(params, **kw):
    base = dict(n_slots=4, max_len=128, kv_mode="paged", page_size=16,
                prefill_chunk=16, prefill_token_budget=32, device="cpu")
    base.update(kw)
    return LLMEngine(TCFG, params, **base)


def _set_knob(monkeypatch, name, value):
    """The same global knob for both runtimes, each from its own
    environment prefix."""
    monkeypatch.setenv(f"RAY_TPU_{name}", value)
    monkeypatch.setenv(f"RAY_TPU_TORCH_{name}", value)


class TestTpKnob:
    """tests/test_tp_decode.py::TestKnobValidation's global-knob cases."""

    def test_global_knob_soft_off(self, weights, monkeypatch):
        assert tapi._client is None
        _set_knob(monkeypatch, "LLM_TP", "2")
        jd = JaxEngine(JCFG, weights[0], kv_mode="dense")
        td = LLMEngine(TCFG, weights[1], kv_mode="dense", device="cpu")
        assert (jd.tp, td.tp) == (1, 1)
        assert jd.mesh is None and td.mesh is None
        assert td._tp_disabled_reason == ""      # off for the mode, as JAX
        jp, tp = _jax_engine(weights[0]), _port_engine(weights[1])
        assert (jp.tp, tp.tp) == (2, 2)
        assert jp.mesh.shape == {"tp": 2} and len(tp.mesh) == 2

    def test_global_knob_misfit_soft_off(self, weights, monkeypatch,
                                         caplog):
        _set_knob(monkeypatch, "LLM_TP", "3")      # 8 heads % 3 != 0
        with caplog.at_level(logging.WARNING):
            jp, tp = _jax_engine(weights[0]), _port_engine(weights[1])
        assert (jp.tp, tp.tp) == (1, 1)
        assert jp.mesh is None and tp.mesh is None
        assert "does not divide" in tp._tp_disabled_reason
        assert any("llm_tp soft-disabled" in r.getMessage()
                   for r in caplog.records)
        # Too few devices: the knob past what the placement offers.
        many = str(8 * len(jax.devices()))
        _set_knob(monkeypatch, "LLM_TP", many)
        jp = _jax_engine(weights[0])
        tp = _port_engine(weights[1], device=["cpu", "cpu"])
        assert (jp.tp, tp.tp) == (1, 1)
        assert tp.mesh is None and tp.device == torch.device("cpu")
        assert "device lists 2 device(s)" in tp._tp_disabled_reason


def _kv_engine(side, params, **kw):
    """tests/test_kv_objects.py's `_engine`, on either side."""
    base = dict(n_slots=4, max_len=256, kv_mode="paged", page_size=16,
                prefill_chunk=16, prefill_token_budget=64, decode_block=4)
    base.update(kw)
    if side == "jax":
        return JaxEngine(JCFG, params, **base)
    return LLMEngine(TCFG, params, device="cpu", **base)


SIDES = ("jax", "port")


def _params(weights, side):
    return weights[0] if side == "jax" else weights[1]


def _dense(side, params, **kw):
    if side == "jax":
        return JaxEngine(JCFG, params, kv_mode="dense", **kw)
    return LLMEngine(TCFG, params, kv_mode="dense", device="cpu", **kw)


class TestKvKnobValidation:
    """tests/test_kv_objects.py::TestKnobValidation, on both engines."""

    @pytest.mark.parametrize("side", SIDES)
    def test_kv_transfer_explicit_requires_paged_chunked(self, weights,
                                                         side):
        p = _params(weights, side)
        with pytest.raises(ValueError, match="page-set transfer"):
            _dense(side, p, kv_transfer=True)
        with pytest.raises(ValueError, match="page-set transfer"):
            _kv_engine(side, p, prefill_chunk=0, kv_transfer=True,
                       prefill_token_budget=0)

    @pytest.mark.parametrize("side", SIDES)
    def test_kv_transfer_requires_page_aligned_chunks(self, weights, side):
        with pytest.raises(ValueError, match="page-set transfer"):
            _kv_engine(side, _params(weights, side), prefill_chunk=24,
                       kv_transfer=True)

    @pytest.mark.parametrize("side", SIDES)
    def test_global_knob_soft_disables_on_unaligned_chunk(
            self, weights, side, monkeypatch):
        _set_knob(monkeypatch, "LLM_KV_TRANSFER", "1")
        eng = _kv_engine(side, _params(weights, side), prefill_chunk=24)
        assert eng.kv_transfer is False

    def test_soft_disable_reason_is_observable(self, weights, monkeypatch,
                                               caplog):
        _set_knob(monkeypatch, "LLM_KV_TRANSFER", "1")
        seen = {}
        for side in SIDES:
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                eng = _kv_engine(side, _params(weights, side),
                                 prefill_chunk=24)
            assert eng.kv_transfer is False
            assert any("soft-disabled" in r.getMessage()
                       for r in caplog.records), caplog.records
            m, snap = eng.metrics(), eng.load_snapshot()
            assert m["kv_transfer"] is False
            assert "page-set transfer" in m["kv_transfer_disabled_reason"]
            assert (snap["kv_transfer_disabled_reason"]
                    == m["kv_transfer_disabled_reason"])
            seen[side] = m["kv_transfer_disabled_reason"]
            store = (JaxKVStore if side == "jax" else LocalKVStore)(
                budget=4)
            on = _kv_engine(side, _params(weights, side), kv_transfer=True,
                            kv_store=store)
            assert "kv_transfer_disabled_reason" not in on.metrics()
            assert "kv_transfer_disabled_reason" not in on.load_snapshot()
        assert seen["jax"] == seen["port"]

    @pytest.mark.parametrize("side", SIDES)
    def test_pool_role_validation(self, weights, side):
        p = _params(weights, side)
        with pytest.raises(ValueError, match="pool_role"):
            _kv_engine(side, p, pool_role="both")
        with pytest.raises(ValueError, match="requires kv_transfer"):
            _kv_engine(side, p, pool_role="prefill", kv_transfer=False)
        with pytest.raises(ValueError, match="page-set transfer"):
            _dense(side, p, pool_role="prefill")

    @pytest.mark.parametrize("side", SIDES)
    def test_global_knob_soft_disables(self, weights, side, monkeypatch):
        _set_knob(monkeypatch, "LLM_KV_TRANSFER", "1")
        p = _params(weights, side)
        assert _dense(side, p).kv_transfer is False
        paged = _kv_engine(side, p)
        assert paged.kv_transfer is True
        assert paged._kv_store is not None
