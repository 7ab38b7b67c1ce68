"""Serving-loop routing + overload shedding, on the port.

Mirrors ``tests/test_router.py`` (every unit class, and the cluster
classes `TestEnactedLoop`, `TestOverloadShedding` and
`TestAffinityCluster`) on the port's serve modules and cluster, with
``LLMDeployment(device="cpu")`` where the JAX tests pin replicas to the
host's platform. Exact comparisons throughout (picks, counts,
token streams); no float tolerance is involved.


Covers the router policies (`serve_router_policy`): p2c_local's
byte-for-byte legacy behavior, p2c_load's blended local+probed scoring
with staleness decay, prefix-affine placement (rendezvous hash + load
spill + death re-pick), the O(1) dead-set behind `_alive`, the
overload-shed gate (typed 503 + Retry-After + `serve_requests_shed_total`
only when pinned at max replicas with queues past the knee), the
enacted-autoscaling loop (scale-down through the drain path with zero
dropped streams; kill -9 mid-enactment re-derives, never double-applies;
`serve_autoscale_max_enact_step` bounds the blast radius), and the
`serve.routes.push` drop fault (handles serve from cache + TTL refresh).
"""

import collections
import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve.api import DeploymentHandle, _rendezvous, note_dead
from ray_tpu_torch.serve.prefix_cache import affinity_key, chunk_hashes


class _FakeAid:
    def __init__(self, b: bytes):
        self._b = b

    def binary(self) -> bytes:
        return self._b

    def hex(self) -> str:
        return self._b.hex()


class _FakeReplica:
    def __init__(self, b: bytes):
        self._actor_id = _FakeAid(b)

    def __repr__(self):
        return f"replica<{self._actor_id.hex()}>"


def _mk_handle(policy: str = "p2c_load", **over) -> DeploymentHandle:
    h = DeploymentHandle("dep")
    h._policy = policy
    h._load_stale_s = over.get("load_stale_s", 5.0)
    h._spill_ongoing = over.get("spill_ongoing", 16.0)
    h._shed_queue_depth = over.get("shed_queue_depth", 0)
    h._shed_retry_after_s = over.get("shed_retry_after_s", 1.0)
    h._affinity_chunk = over.get("affinity_chunk", 8)
    return h


@pytest.fixture
def dead_state():
    """Isolate the process-wide dead-actor set per test."""
    saved = dict(serve_api._dead_state)
    serve_api._dead_state["client"] = object()  # block re-arming
    serve_api._dead_state["dead"] = collections.OrderedDict()
    yield serve_api._dead_state
    serve_api._dead_state.clear()
    serve_api._dead_state.update(saved)


class TestAffinityKey:
    def test_key_is_the_chunk_chain_head(self):
        toks = list(range(20))
        assert affinity_key(toks, 8) == chunk_hashes(toks[:8], 8)[0]
        # Only the first chunk matters: same head, different tails agree.
        assert affinity_key(toks, 8) == affinity_key(toks[:8] + [99], 8)
        assert affinity_key(toks, 8) != affinity_key([1] + toks[1:], 8)

    def test_short_prompts_still_colocate(self):
        assert affinity_key([1, 2, 3], 8) == affinity_key([1, 2, 3], 8)
        assert affinity_key([1, 2, 3], 8) != affinity_key([1, 2, 4], 8)

    def test_rendezvous_stable_and_minimal_churn(self):
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(5)]
        keys = [affinity_key([i, i + 1, i + 2], 8) for i in range(64)]
        before = {k: _rendezvous(k, reps) for k in keys}
        assert before == {k: _rendezvous(k, reps) for k in keys}  # stable
        # Remove one replica: only ITS keys move (rendezvous property).
        victim = reps[2]
        reps2 = [r for r in reps if r is not victim]
        for k, owner in before.items():
            after = _rendezvous(k, reps2)
            if owner is not victim:
                assert after is owner
            else:
                assert after is not victim


class TestHandleRouting:
    def _legacy_pick(self, h, replicas):
        a, b = random.sample(replicas, 2)
        la = h._local_inflight.get(a._actor_id.binary(), 0)
        lb = h._local_inflight.get(b._actor_id.binary(), 0)
        return a if la <= lb else b

    def test_p2c_local_is_byte_for_byte_legacy(self):
        h = _mk_handle("p2c_local")
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(4)]
        # Probed load says replica 0 is drowning; legacy must IGNORE it.
        h._loads = {reps[0]._actor_id.hex(): {
            "ongoing": 1000.0, "queue_depth": 1000.0, "ts": time.time()}}
        for seed in range(32):
            h._local_inflight = {
                reps[seed % 4]._actor_id.binary(): seed % 3}
            random.seed(seed)
            expected = self._legacy_pick(h, reps)
            random.seed(seed)
            assert h._p2c(reps) is expected

    def test_p2c_load_prefers_probed_light_replica(self):
        h = _mk_handle("p2c_load")
        a, b = _FakeReplica(b"a" * 8), _FakeReplica(b"b" * 8)
        now = time.time()
        h._loads = {a._actor_id.hex(): {"ongoing": 50.0, "ts": now},
                    b._actor_id.hex(): {"ongoing": 0.0, "ts": now}}
        # Local counts equal: the probed signal must decide, every time.
        assert all(h._p2c([a, b]) is b for _ in range(32))

    def test_stale_probe_decays_to_local_signal(self):
        h = _mk_handle("p2c_load", load_stale_s=1.0)
        a = _FakeReplica(b"a" * 8)
        h._loads = {a._actor_id.hex(): {"ongoing": 100.0,
                                        "ts": time.time() - 10.0}}
        # Fully stale probe contributes nothing: blended == local.
        assert h._blended(a) == 0.0
        h._local_inflight[a._actor_id.binary()] = 3
        assert h._blended(a) == 3.0
        # Fresh probe contributes fully.
        h._loads[a._actor_id.hex()]["ts"] = time.time()
        assert h._blended(a) > 100.0

    def test_affinity_prefers_rendezvous_replica(self):
        h = _mk_handle("affinity", spill_ongoing=4.0)
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(4)]
        key = affinity_key(list(range(16)), 8)
        pref = _rendezvous(key, reps)
        assert all(h._p2c(reps, key) is pref for _ in range(16))
        # No key (non-LLM payload) → plain p2c_load.
        h._loads = {r._actor_id.hex(): {"ongoing": 0.0, "ts": time.time()}
                    for r in reps}
        assert h._p2c(reps, None) in reps

    def test_affinity_spills_when_preferred_is_hot(self):
        h = _mk_handle("affinity", spill_ongoing=4.0)
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(3)]
        key = affinity_key(list(range(16)), 8)
        pref = _rendezvous(key, reps)
        now = time.time()
        h._loads = {r._actor_id.hex(): {"ongoing": 0.0, "ts": now}
                    for r in reps}
        h._loads[pref._actor_id.hex()]["ongoing"] = 10.0  # >= spill
        picks = {h._p2c(reps, key) for _ in range(32)}
        # Spilled: the load-balanced pick always lands on a cold replica.
        assert pref not in picks and picks

    def test_affinity_repicks_after_preferred_death(self, dead_state):
        h = _mk_handle("affinity", spill_ongoing=100.0)
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(3)]
        key = affinity_key(list(range(16)), 8)
        pref = _rendezvous(key, reps)
        h._replicas = list(reps)
        h.evict_replica(pref, dead=True)
        survivors = h._alive(reps)
        assert pref not in survivors and len(survivors) == 2
        # The re-pick is stable on a SURVIVOR (rendezvous over the rest).
        again = _rendezvous(key, survivors)
        assert again is not pref
        assert h._p2c(survivors, key) is again

    def test_alive_is_dead_set_lookup(self, dead_state):
        h = _mk_handle()
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(3)]
        assert h._alive(reps) == reps
        note_dead(reps[1]._actor_id.binary())
        assert h._alive(reps) == [reps[0], reps[2]]

    def test_only_confirmed_death_seeds_dead_set(self, dead_state):
        """ActorUnavailableError can be transient (dial timeout, slow
        start): it must failover but NEVER seed the process-wide dead
        set — an entry there outlives every table refresh and would
        permanently blacklist a live replica."""
        from ray_tpu_torch.exceptions import (ActorDiedError,
                                        ActorUnavailableError)
        from ray_tpu_torch.serve.http_proxy import confirmed_dead, failover_mode

        unavailable = ActorUnavailableError("ActorUnavailableError",
                                            "dial timed out", "")
        died = ActorDiedError("ActorDiedError", "worker exited", "")
        assert failover_mode(unavailable) == "death"   # still fails over
        assert not confirmed_dead(unavailable)         # ...locally only
        assert confirmed_dead(died)
        h = _mk_handle()
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(2)]
        h._replicas = list(reps)
        h.evict_replica(reps[0], dead=confirmed_dead(unavailable))
        assert h._alive(reps) == reps    # table refresh resurrects it
        h.evict_replica(reps[1], dead=confirmed_dead(died))
        assert h._alive(reps) == [reps[0]]

    def test_row_age_is_clock_skew_free(self):
        """Probe age uses same-clock differences (controller table ts −
        probe ts, plus local monotonic since receipt): a controller
        whose wall clock is minutes off must not mark every probe
        stale (silently disabling blended routing + shedding)."""
        h = _mk_handle("p2c_load", load_stale_s=5.0)
        a = _FakeReplica(b"a" * 8)
        skewed_now = time.time() - 3600.0     # controller 1h behind us
        h._loads = {a._actor_id.hex(): {"ongoing": 10.0,
                                        "ts": skewed_now - 0.5}}
        h._loads_ref = (skewed_now, time.monotonic())
        assert h._row_age(h._loads[a._actor_id.hex()]) < 1.0
        assert h._blended(a) > 8.0            # probe reads fresh
        # Probe genuinely old on the controller's own clock: stale.
        h._loads[a._actor_id.hex()]["ts"] = skewed_now - 60.0
        assert h._blended(a) == 0.0

    def test_affinity_key_method_gating(self):
        h = _mk_handle("p2c_load")
        assert h.affinity_key({"prompt_ids": [1, 2, 3]}) is None
        h = _mk_handle("affinity")
        assert h.affinity_key({"prompt_ids": [1, 2, 3]}) is not None
        assert h.affinity_key({"no_ids": 1}) is None
        assert h.affinity_key([1, 2, 3]) is None
        assert h.affinity_key({"prompt_ids": []}) is None


class TestWarmDiscoveryRouting:
    """Pushed KV summaries: the handle hints and routes
    against a LOCAL push-refreshed table — discovery never costs the
    request path an RPC."""

    def _head(self, ids, chunk=8):
        return affinity_key(ids, chunk).hex()[:16]

    def test_kv_hint_attaches_discover_only_when_warm(self):
        # Deliberately NOT the affinity policy: discovery is about
        # where pages ARE, not where requests go.
        h = _mk_handle("p2c_load")
        ids = list(range(16))
        payload = {"prompt_ids": ids, "max_tokens": 4}
        assert h.kv_hint(payload) is payload          # nothing warm yet
        h._kv_warm = frozenset({self._head(ids)})
        hinted = h.kv_hint(payload)
        assert hinted is not payload
        assert hinted["kv"] == {"discover": True}
        assert "kv" not in payload                    # copy, no mutation
        cold = {"prompt_ids": [9] * 16}
        assert h.kv_hint(cold) is cold                # head not warm
        # A payload already carrying a descriptor (handoff/drain
        # continuation) is strictly richer: pass through untouched.
        rich = {"prompt_ids": ids, "kv": {"keys": ["aa"]}}
        assert h.kv_hint(rich) is rich
        bare = [1, 2, 3]
        assert h.kv_hint(bare) is bare                # non-dict payload
        empty = {"no_ids": 1}
        assert h.kv_hint(empty) is empty

    def test_p2c_routes_to_pushed_summary_holder(self):
        """The rendezvous pick never donated the chain but another
        replica advertises it: route to the holder (its pages adopt)."""
        h = _mk_handle("affinity", spill_ongoing=8.0)
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(4)]
        key = affinity_key(list(range(16)), 8)
        pref = _rendezvous(key, reps)
        holder = next(r for r in reps if r is not pref)
        now = time.time()
        h._loads = {r._actor_id.hex(): {"ongoing": 0.0, "ts": now}
                    for r in reps}
        h._kv_summaries = {
            holder._actor_id.hex(): frozenset({key.hex()[:16]})}
        assert all(h._p2c(reps, key) is holder for _ in range(16))

    def test_holder_override_yields_to_pref_summary_and_spill(self):
        h = _mk_handle("affinity", spill_ongoing=8.0)
        reps = [_FakeReplica(bytes([i]) * 8) for i in range(4)]
        key = affinity_key(list(range(16)), 8)
        head = key.hex()[:16]
        pref = _rendezvous(key, reps)
        holder = next(r for r in reps if r is not pref)
        now = time.time()
        h._loads = {r._actor_id.hex(): {"ongoing": 0.0, "ts": now}
                    for r in reps}
        # The preferred replica ITSELF advertises the chain: no
        # override — affinity already lands on warm pages.
        h._kv_summaries = {
            pref._actor_id.hex(): frozenset({head}),
            holder._actor_id.hex(): frozenset({head})}
        assert all(h._p2c(reps, key) is pref for _ in range(16))
        # A hot holder never beats load balancing: the override obeys
        # the SAME spill threshold, and routing falls back to pref.
        h._kv_summaries = {holder._actor_id.hex(): frozenset({head})}
        h._loads[holder._actor_id.hex()]["ongoing"] = 50.0
        assert all(h._p2c(reps, key) is pref for _ in range(16))

    def test_load_row_caps_summary_keeping_newest(self):
        """Satellite: the controller is the last line against an
        oversized per-replica summary — it re-applies
        serve_kv_summary_max, truncating oldest-first (newest-last
        entries are the ones routing should chase)."""
        from ray_tpu_torch.core.config import runtime_config
        from ray_tpu_torch.serve.controller import ServeController

        cap = runtime_config().serve_kv_summary_max
        summary = [f"{i:016x}" for i in range(cap + 40)]
        row = ServeController._load_row(
            {"load": {"queue_depth": 1.0, "kv_summary": summary},
             "inflight": 0, "ts": 123.0})
        assert row["kv_summary"] == summary[-cap:]
        assert row["queue_depth"] == 1.0 and row["ts"] == 123.0
        # No summary → no key (rows of non-donating replicas stay lean).
        bare = ServeController._load_row({"load": {}, "ts": 1.0})
        assert "kv_summary" not in bare


class TestShedVerdict:
    def _loads(self, depths, age_s=0.0):
        now = time.time() - age_s
        return {f"r{i}": {"queue_depth": float(d), "ongoing": float(d),
                          "ts": now}
                for i, d in enumerate(depths)}

    def test_sheds_only_when_pinned_and_every_queue_deep(self):
        h = _mk_handle(shed_queue_depth=4)
        h._loads = self._loads([10, 9, 8])
        h._overload_pinned = False
        assert h.shed_verdict() is None          # not pinned: never shed
        h._overload_pinned = True
        out = h.shed_verdict()
        assert out is not None and out["retry_after_s"] == 1.0
        assert out["queue_depth_min"] == 8.0
        # One replica below threshold = spare capacity: no shed.
        h._loads = self._loads([10, 2, 9])
        assert h.shed_verdict() is None

    def test_stale_probes_and_disabled_threshold_never_shed(self):
        h = _mk_handle(shed_queue_depth=4)
        h._overload_pinned = True
        h._loads = self._loads([10, 10], age_s=60.0)
        assert h.shed_verdict() is None          # no fresh evidence
        h = _mk_handle(shed_queue_depth=0)
        h._overload_pinned = True
        h._loads = self._loads([10, 10])
        assert h.shed_verdict() is None          # knob off


# --------------------------------------------------------------- cluster


def _post(port, route, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


class TestEnactedLoop:
    """serve_autoscale_mode=enact end to end: the recommendation drives
    num_replicas through the normal reconcile spawn/drain paths."""

    ENACT_CFG = {
        "serve_autoscale_mode": "enact",
        "serve_autoscale_interval_s": 1.0,
        "serve_autoscale_window_s": 6.0,
        "serve_autoscale_up_sustain_s": 1.0,
        "serve_autoscale_down_sustain_s": 2.0,
        "serve_autoscale_up_cooldown_s": 1.0,
        "serve_autoscale_down_cooldown_s": 2.0,
        "serve_drain_timeout_s": 20.0,
        "worker_profile_flush_interval_s": 0.5,
    }

    def test_enacted_scale_down_drains_zero_dropped_streams(self):
        """Idle load → the autoscaler recommends 1 of 2 replicas → the
        enacted scale-down goes through the DRAIN path: token
        streams running across the enactment complete byte-identically
        to an uninterrupted run (cursor-exact failover), never drop."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

        cfg = gpt.GPTConfig.by_name("tiny")
        prompt = [5, 9, 2, 7, 1, 4, 3, 8]
        engine_kwargs = {"prefill_buckets": (16, 32), "kv_mode": "paged",
                         "page_size": 16, "prefill_chunk": 8,
                         "prefill_token_budget": 32}
        base = LLMEngine(cfg, None, n_slots=2, max_len=96, device="cpu",
                         **engine_kwargs)
        ref = base.submit(prompt, max_tokens=24)
        while not ref.done.is_set():
            base.step()
        expected = list(ref.out_ids)

        ray_tpu_torch.init(num_cpus=4, _system_config=self.ENACT_CFG)
        try:
            dep = serve.deployment(
                LLMDeployment, name="enactllm").options(
                num_replicas=2,
                autoscaling_config={"min_replicas": 1, "max_replicas": 2,
                                    "target_ongoing_requests": 6.0},
            ).bind("tiny", n_slots=2, max_len=96, device="cpu",
                   engine_kwargs=engine_kwargs)
            handle = serve.run(dep, timeout=300.0)
            assert serve.status()["enactllm"]["live_replicas"] == 2

            stop = threading.Event()
            bad: list = []
            done_streams = [0]

            def streamer():
                while not stop.is_set():
                    try:
                        toks = list(handle.stream(
                            {"prompt_ids": prompt, "max_tokens": 24}))
                    except Exception as e:  # noqa: BLE001
                        bad.append(f"dropped: {e!r}")
                        return
                    if toks != expected:
                        bad.append(f"mismatch: {toks}")
                        return
                    done_streams[0] += 1

            threads = [threading.Thread(target=streamer, daemon=True)
                       for _ in range(3)]
            for t in threads:
                t.start()
            # Wait for the enacted scale-down to land and settle.
            deadline = time.monotonic() + 60
            st = None
            while time.monotonic() < deadline:
                st = serve.status()["enactllm"]
                if (st["live_replicas"] == 1
                        and st["draining_replicas"] == 0
                        and st["num_replicas"] == 1):
                    break
                time.sleep(0.5)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            assert st and st["num_replicas"] == 1, (
                f"autoscaler never enacted the scale-down: {st}")
            assert st["live_replicas"] == 1
            assert not bad, f"streams dropped/mismatched: {bad[:3]}"
            assert done_streams[0] > 0
            # The enactment is explainable: the latest decision came
            # from the enact-mode autoscaler, not the legacy policy.
            assert st["autoscale"] and st["autoscale"]["mode"] == "enact"
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def test_enact_kill9_rederives_and_step_guard_bounds_moves(self):
        """kill -9 exactly between the decision record and the scale
        apply: the restarted controller re-derives the recommendation
        from the series store against its checkpointed num_replicas and
        converges — stepwise, because serve_autoscale_max_enact_step=1
        bounds every enactment to one replica."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _get_controller

        cfg = dict(self.ENACT_CFG)
        cfg["serve_autoscale_max_enact_step"] = 1
        ray_tpu_torch.init(num_cpus=6, _system_config=cfg)
        try:
            @serve.deployment(
                name="steady3", num_replicas=3,
                autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                    "target_ongoing_requests": 4.0})
            def steady(req):
                return {"ok": True}

            handle = serve.run(steady, timeout=300.0)
            ctrl = _get_controller()
            # First enactment (idle → scale down) dies mid-apply.
            ray_tpu_torch.get(ctrl.install_chaos.remote(
                [{"site": "serve.controller.enact", "action": "kill"}]),
                timeout=30)

            stop = threading.Event()
            failures: list = []

            def traffic():
                while not stop.is_set():
                    try:
                        assert ray_tpu_torch.get(handle.remote({}),
                                           timeout=60)["ok"]
                    except Exception as e:  # noqa: BLE001
                        failures.append(repr(e))
                        return
                    time.sleep(0.1)

            t = threading.Thread(target=traffic, daemon=True)
            t.start()
            # Watch num_replicas: it must converge 3 → 1 without ever
            # moving by more than the step guard between observations.
            seen = [3]
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                try:
                    st = serve.status().get("steady3")
                except Exception:  # noqa: BLE001 — controller mid-restart
                    time.sleep(0.3)
                    continue
                if st and st["num_replicas"] != seen[-1]:
                    seen.append(st["num_replicas"])
                if (st and st["num_replicas"] == 1
                        and st["live_replicas"] == 1
                        and st["draining_replicas"] == 0):
                    break
                time.sleep(0.2)
            stop.set()
            t.join(timeout=30)
            assert seen[-1] == 1, (
                f"enact did not converge after kill -9: {seen}")
            # Step guard: every observed move is a single replica — the
            # restarted controller re-derived (3→2→1), it never
            # double-applied or jumped past the clamp.
            for prev, nxt in zip(seen, seen[1:]):
                assert abs(nxt - prev) == 1, f"enact step > 1: {seen}"
            assert not failures, f"traffic failed: {failures[:3]}"
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def test_routes_push_drop_serves_from_cache_and_ttl_refreshes(self):
        """Chaos-drop every routing push: handles keep serving from the
        cached table and converge to a redeploy via the TTL refresh —
        routing never wedges on a lost notify."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _get_controller

        ray_tpu_torch.init(num_cpus=4, _system_config={
            "serve_handle_refresh_ttl_s": 2.0})
        try:
            @serve.deployment(name="pushy")
            class V:
                def __init__(self, tag="a"):
                    self.tag = tag

                def __call__(self, _x):
                    return self.tag

            handle = serve.run(V.bind("a"), _blocking_until_ready=True)
            assert ray_tpu_torch.get(handle.remote(0), timeout=60) == "a"
            ctrl = _get_controller()
            ray_tpu_torch.get(ctrl.install_chaos.remote(
                [{"site": "serve.routes.push", "action": "drop",
                  "count": -1}]), timeout=30)
            serve.run(V.bind("b"), _blocking_until_ready=True)
            # Pushes are dropped: convergence rides the 2s TTL. Calls
            # must keep succeeding THROUGHOUT (cache, then new table).
            deadline = time.monotonic() + 20
            val = None
            while time.monotonic() < deadline:
                val = ray_tpu_torch.get(handle.remote(0), timeout=60)
                if val == "b":
                    break
                time.sleep(0.2)
            assert val == "b", "handle never converged without pushes"
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()


class TestOverloadShedding:
    def test_shed_typed_503_retry_after_and_counter(self):
        """Pinned at max replicas with every queue past the threshold:
        the proxy sheds with a typed 503 + Retry-After and counts it in
        serve_requests_shed_total — while the in-flight requests keep
        decoding to completion (bounded degradation, not collapse)."""
        from ray_tpu_torch import serve, state
        from ray_tpu_torch.serve.llm import LLMDeployment

        stop = threading.Event()
        threads: list = []
        ray_tpu_torch.init(num_cpus=4, _system_config={
            "serve_autoscale_mode": "enact",
            "serve_autoscale_interval_s": 1.0,
            "serve_autoscale_window_s": 5.0,
            "serve_autoscale_up_sustain_s": 0.5,
            "serve_overload_queue_depth": 2,
            "serve_overload_retry_after_s": 3.0,
            "worker_profile_flush_interval_s": 0.5,
        })
        try:
            dep = serve.deployment(
                LLMDeployment, name="shedllm").options(
                num_replicas=1, route_prefix="/shed",
                autoscaling_config={"min_replicas": 1, "max_replicas": 1,
                                    "target_ongoing_requests": 1.0},
            ).bind("tiny", n_slots=1, max_len=128, device="cpu",
                   engine_kwargs={"prefill_buckets": (16, 32),
                                  "decode_block": 1})
            serve.run(dep, timeout=300.0)
            _proxy, port = serve.start_proxy()
            # Warm the route + the replica.
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    _post(port, "/shed",
                          {"prompt_ids": [1, 2, 3], "max_tokens": 2})
                    break
                except Exception:  # noqa: BLE001
                    time.sleep(0.5)

            # Flood: 8 long generations against 1 slot → queue depth 7.
            def flood():
                while not stop.is_set():
                    try:
                        _post(port, "/shed",
                              {"prompt_ids": [4, 5, 6],
                               "max_tokens": 96}, timeout=300)
                    except Exception:  # noqa: BLE001 — shed/timeout: refill
                        time.sleep(0.2)

            threads += [threading.Thread(target=flood, daemon=True)
                        for _ in range(8)]
            for t in threads:
                t.start()
            # Probe with tiny requests until the shed engages.
            shed_resp = None
            # A probe that is not shed queues behind the flood: a short
            # client timeout keeps the probes coming on a loaded host.
            deadline = time.time() + 120
            while time.time() < deadline and shed_resp is None:
                try:
                    _post(port, "/shed",
                          {"prompt_ids": [9], "max_tokens": 1},
                          timeout=5)
                except urllib.error.HTTPError as e:
                    if e.code == 503:
                        body = json.loads(e.read() or b"{}")
                        if body.get("type") == "overloaded":
                            shed_resp = (e.headers.get("Retry-After"),
                                         body)
                            break
                except Exception:  # noqa: BLE001 — proxy busy: retry
                    pass
                time.sleep(0.5)
            stop.set()
            assert shed_resp is not None, "overload never shed"
            retry_after, body = shed_resp
            assert retry_after == "3"
            assert body["type"] == "overloaded"
            assert body["retry_after_s"] == 3.0
            # The shed counter reached the cluster metrics hub.
            deadline = time.time() + 20
            shed_total = 0.0
            while time.time() < deadline and shed_total <= 0:
                shed_total = sum(
                    r["value"] for r in state.metrics_rows()
                    if r["name"] == "serve_requests_shed_total")
                time.sleep(0.5)
            assert shed_total > 0
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
            # The flood's long generations end with the cluster, not
            # after 8 x 96 more tokens on one slot.
            stop.set()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)


class TestAffinityCluster:
    def test_same_prefix_requests_colocate_and_warm_the_cache(self):
        """serve_router_policy=affinity: equal-prefix requests rendezvous
        onto ONE replica of two, whose prefix cache then serves them warm
        (per-replica hit rate visible through the load surface)."""
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.api import _get_controller

        from ray_tpu_torch.serve.llm import LLMDeployment

        ray_tpu_torch.init(num_cpus=4, _system_config={
            "serve_router_policy": "affinity",
            "llm_prefill_chunk": 8,
            "serve_router_spill_ongoing": 50.0,
        })
        try:
            engine_kwargs = {"prefill_buckets": (16, 32),
                             "kv_mode": "paged", "page_size": 16,
                             "prefill_chunk": 8,
                             "prefill_token_budget": 32,
                             "prefix_cache": True}
            dep = serve.deployment(
                LLMDeployment, name="affinellm").options(
                num_replicas=2).bind(
                "tiny", n_slots=2, max_len=96, device="cpu",
                engine_kwargs=engine_kwargs)
            handle = serve.run(dep, timeout=300.0)
            prompt = list(range(24))
            for _ in range(10):
                ray_tpu_torch.get(handle.method(
                    "__call__", {"prompt_ids": prompt, "max_tokens": 4}),
                    timeout=300)
            # Give the stats probe a tick, then read the load surface.
            ctrl = _get_controller()
            deadline = time.time() + 30
            hits = []
            while time.time() < deadline:
                load = ray_tpu_torch.get(ctrl.get_load.remote(), timeout=30)
                rows = load["affinellm"]["replicas"]
                hits = [(r.get("load") or {}).get("prefix_cache_hits", 0)
                        for r in rows]
                if sum(hits) >= 9:
                    break
                time.sleep(0.5)
            # All 10 equal-prefix requests landed on one replica: its
            # cache served every admission after the first warm; the
            # other replica stayed cold (affinity, not round-robin).
            assert max(hits) >= 9, f"affinity did not colocate: {hits}"
            assert min(hits) == 0, f"prefix leaked across replicas: {hits}"
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
