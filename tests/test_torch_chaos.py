"""PyTorch port vs the JAX package: chaos injection
(``ray_tpu_torch/chaos.py`` against ``ray_tpu/chaos.py``).

The JAX package's unit cases (tests/test_chaos.py ``TestChaosHarness``)
run on both modules and fire on the same hits: counter rules, a seeded
probability, delay, uninstall, environment arming and a malformed spec
that disarms. Then the engine's fault point: a "raise" rule at
``llm.decode_window`` with ``after=2`` kills the engine thread of both
engines on the same traffic; every request ends with an ``engine died``
error, a later submit raises, and the tokens emitted before the death
are equal. Tiny config, fp32, greedy.

``TestZeroDrop`` is the reference's acceptance scenario
(``tests/test_chaos.py::TestZeroDrop`` through ``bench_chaos.py``) on the
port, through ``bench_chaos_torch.run_scenario``: 32 SSE streams, 3
replicas, one killed mid-decode and one drained by a scale-down to 2.
The weights are the JAX package's tiny init at the reference's seed,
carried into the port and loaded by the baseline and every replica from
one checkpoint; the expected streams come from the JAX engine with the
reference's knobs, and the port's baseline and every served stream must
equal them exactly.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import chaos as jchaos
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.serve.llm import LLMEngine

MODULES = [jchaos, tchaos]
SITE = "serve.replica.probe"


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    for chaos in MODULES:
        chaos.uninstall()


def _fired(chaos, rules, n):
    chaos.install(rules)
    out = []
    for _ in range(n):
        try:
            chaos.hit(SITE)
            out.append(0)
        except chaos.ChaosError:
            out.append(1)
    return out, chaos.hits(SITE)


@pytest.mark.parametrize("rules,n", [
    ([{"site": SITE, "action": "raise", "after": 2, "count": 2}], 6),
    ([{"site": SITE, "action": "drop", "count": -1, "after": 1}], 5),
    ([{"site": SITE, "action": "raise", "p": 0.5, "count": -1,
       "seed": 7}], 32),
    ([{"site": SITE, "action": "raise", "p": 0.5, "count": -1,
       "seed": 8}], 32),
    ([{"site": SITE, "action": "raise", "p": 0.3, "count": 3,
       "seed": 1, "after": 4}], 64),
    (json.dumps([{"site": SITE, "action": "raise", "p": 0.0}]), 4),
    ([{"site": "llm.decode_window", "action": "raise"}], 3),
], ids=["counter", "drop_forever", "seed7", "seed8", "seeded_budget",
        "json_p0", "other_site"])
def test_rules_fire_on_the_same_hits(rules, n):
    (jout, jhits), (tout, thits) = (_fired(c, rules, n) for c in MODULES)
    assert (tout, thits) == (jout, jhits) and thits == n
    if isinstance(rules, list) and rules[0].get("after") == 2:
        assert tout == [0, 0, 1, 1, 0, 0]   # after=2, count=2


def test_seeded_probability_is_reproducible():
    run = lambda c, seed: _fired(c, [{"site": SITE, "action": "raise",
                                       "p": 0.5, "count": -1,
                                       "seed": seed}], 32)[0]
    a, b, c = run(tchaos, 7), run(tchaos, 7), run(tchaos, 8)
    assert a == b and a != c and 0 < sum(a) < 32
    assert a == run(jchaos, 7)
    for seed in range(4):
        for n in range(16):
            assert tchaos._coin(seed, SITE, n, 0.4) == jchaos._coin(
                seed, SITE, n, 0.4)


@pytest.mark.parametrize("chaos", MODULES, ids=["jax", "torch"])
def test_delay_action_and_uninstall(chaos):
    chaos.install([{"site": SITE, "action": "delay", "delay_s": 0.05,
                    "count": 1}])
    assert chaos.active()
    t0 = time.perf_counter()
    chaos.hit(SITE)
    assert time.perf_counter() - t0 >= 0.05
    chaos.uninstall()
    assert not chaos.active() and chaos.hits(SITE) == 0
    chaos.hit(SITE)   # disarmed: a no-op


@pytest.mark.parametrize("chaos", MODULES, ids=["jax", "torch"])
def test_env_arming_and_malformed_spec(chaos, monkeypatch):
    assert chaos.ENV_SPEC == "RAY_TPU_CHAOS"
    monkeypatch.setenv(chaos.ENV_SPEC, json.dumps(
        [{"site": SITE, "action": "drop", "count": 1}]))
    chaos._arm_from_env()
    assert chaos.active()
    with pytest.raises(chaos.ChaosError):
        chaos.hit(SITE)
    chaos.hit(SITE)   # count spent
    for bad in ("not json", '[{"site": "x", "action": "explode"}]'):
        monkeypatch.setenv(chaos.ENV_SPEC, bad)
        chaos._arm_from_env()   # disarms loudly, does not raise
        assert not chaos.active()


def test_sites_and_rule_fields_match():
    assert tchaos.SITES == jchaos.SITES
    assert tchaos._ACTIONS == jchaos._ACTIONS
    assert [f.name for f in tchaos.ChaosRule.__dataclass_fields__.values()
            ] == [f.name for f in
                  jchaos.ChaosRule.__dataclass_fields__.values()]


# ------------------------------------------------- the engine's fault point

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
MODES = {
    "dense": dict(kv_mode="dense"),
    "chunked": dict(kv_mode="paged", page_size=16, prefill_chunk=16,
                    prefill_token_budget=32),
}


@pytest.fixture(scope="module")
def weights():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               TCFG, device="cpu")


def _killed(eng, chaos):
    """Traffic queued before the thread starts (a schedule that does not
    depend on timing), a raise rule at the third decode window."""
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, TCFG.vocab_size, n)))
               for n in (5, 19, 9)]
    reqs = [eng.submit(p, max_tokens=20) for p in prompts]
    chaos.install([{"site": "llm.decode_window", "action": "raise",
                    "after": 2}])
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(timeout=120), "a request hung"
    finally:
        eng.stop()
        chaos.uninstall()
    assert all(r.error and r.error.startswith("engine died: ChaosError(")
               and "chaos[llm.decode_window]" in r.error for r in reqs), [
        r.error for r in reqs]
    with pytest.raises(RuntimeError, match="engine died"):
        eng.submit([1, 2], max_tokens=2)
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_window_raise_kills_both_engines_alike(weights, mode):
    jp, tp = weights
    kw = dict(n_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
              decode_block=2, **MODES[mode])
    jout = _killed(JaxEngine(JCFG, jp, **kw), jchaos)
    tout = _killed(LLMEngine(TCFG, tp, device="cpu", **kw), tchaos)
    assert tout == jout
    # Two windows of 2 ran before the third window's hit raised.
    assert sum(map(len, tout)) > 0


# ------------------------------------------ the zero-drop acceptance run

class TestZeroDrop:
    """The committed acceptance scenario (the code path of
    bench_chaos_torch.py): 32 concurrent SSE streams, one replica killed
    mid-decode, one drained by scale-down: zero dropped requests, zero
    duplicated or missing tokens against the JAX engine's streams."""

    def test_acceptance_32_streams_kill_plus_drain(self, tmp_path):
        import bench_chaos_torch
        from ray_tpu_torch.train.checkpoint import Checkpoint

        # The reference's scenario: tiny (here fp32), seed 0, and its
        # engine knobs (run_scenario's defaults are the reference's).
        n_slots, max_len, chunk, max_tokens = 4, 96, 8, 12
        jp = jgpt.init_params(JCFG, jax.random.key(0))
        tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             TCFG, device="cpu")
        ckpt = Checkpoint.from_dict({"params": tp}).to_directory(
            str(tmp_path / "params"))
        prompts = bench_chaos_torch._prompts(TCFG.vocab_size, 32, 12, 0)
        jeng = JaxEngine(JCFG, jp, n_slots=n_slots, max_len=max_len,
                         prefill_buckets=(16, 32), kv_mode="paged",
                         page_size=16, prefill_chunk=chunk,
                         prefill_token_budget=n_slots * chunk)
        jax_streams = []
        for p in prompts:
            req = jeng.submit(p, max_tokens=max_tokens)
            while not req.done.is_set():
                jeng.step()
            jax_streams.append(list(req.out_ids))

        detail: dict = {}
        t0 = time.perf_counter()
        row = bench_chaos_torch.run_scenario(
            clients=32, replicas=3, scale_down_to=2, max_tokens=max_tokens,
            drain_timeout_s=2.0, seed=0, model=TCFG,
            params_checkpoint=ckpt, device="cpu", detail=detail)
        row["test_wall_s"] = time.perf_counter() - t0
        assert detail["prompts"] == prompts
        assert detail["expected"] == jax_streams
        assert detail["streams"] == jax_streams, detail["errors"]
        assert row["dropped"] == 0, row
        assert row["mismatched_streams"] == 0, row
        assert row["completed"] == 32, row
        assert row["tokens_received"] == row["tokens_expected"] == 32 * 12
        assert row["final_live_replicas"] == 2, row
        assert row["final_draining_replicas"] == 0, row
        # The kill was not vacuous: streams failed over off the victim.
        assert row["serve_failovers_total"] >= 1, row
