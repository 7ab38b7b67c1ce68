"""The port's JAX-free serve modules against the JAX package's, on the
same inputs, with no cluster.

Each case feeds both packages' module the same seeded inputs and
requires equal results: `AutoscalePolicy.from_config` and the full
`ShadowAutoscaler` decision records over one fake series sequence and
clock (the wall-clock ``ts`` stamp aside, read under one frozen clock),
`window_stats`, `SloMonitor` statuses (burn rates, quantile estimates)
on the same rows, the handle's `_row_age`, `_blended`, `_p2c`,
`affinity_key`, `_rendezvous` and `shed_verdict` over the same fake
replicas and load rows as a seeded pick sequence, `ServeConfig.from_dict`
results and which malformed configs raise, `ObjectKVStore` and
`sweep_cluster` on the same fake client (index rows, freed refs,
counters), and `LLMDeployment._handoff_record`.

Tolerance: exact equality throughout; where floats are compared they
are held within 1e-12 relative (`_same`).
"""

import dataclasses
import json
import math
import random
import time
import types

import numpy as np
import pytest

from ray_tpu import slo as jslo
from ray_tpu.core.config import Config as JConfig
from ray_tpu.serve import api as japi
from ray_tpu.serve import autoscale as jas
from ray_tpu.serve import kv_objects as jkvo
from ray_tpu.serve import schema as jschema
from ray_tpu.serve.llm import LLMDeployment as JDeployment
from ray_tpu_torch import slo as tslo
from ray_tpu_torch.core.config import Config as TConfig
from ray_tpu_torch.serve import api as tapi
from ray_tpu_torch.serve import autoscale as tas
from ray_tpu_torch.serve import kv_objects as tkvo
from ray_tpu_torch.serve import schema as tschema
from ray_tpu_torch.serve.llm import LLMDeployment as TDeployment

REL = 1e-12


def _same(a, b, path="$"):
    """Equal structures; floats within REL relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
            return
        assert abs(a - b) <= REL * max(abs(a), abs(b)), (path, a, b)
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
        return
    assert a == b, (path, a, b)


@pytest.fixture
def frozen_clock(monkeypatch):
    """One wall clock and one monotonic clock for both packages."""
    clock = {"wall": 1.7e9, "mono": 5000.0}
    monkeypatch.setattr(time, "time", lambda: clock["wall"])
    monkeypatch.setattr(time, "monotonic", lambda: clock["mono"])
    return clock


# ------------------------------------------------------------ autoscale


def _series_sequence(seed, n_steps):
    """Seeded per-step series values (None = an absent series)."""
    rng = np.random.default_rng(seed)
    names = ("serve_replica_ongoing", "serve_replica_queue_depth",
             "serve_replica_ttft_ewma_ms", "slo_burn_rate")
    steps = []
    for i in range(n_steps):
        vals = {}
        for name in names:
            if rng.random() < 0.1:
                vals[name] = None
                continue
            scale = {"serve_replica_ongoing": 30.0,
                     "serve_replica_queue_depth": 20.0,
                     "serve_replica_ttft_ewma_ms": 1500.0,
                     "slo_burn_rate": 2.5}[name]
            n_series = int(rng.integers(1, 4))
            vals[name] = [
                {"points": [[1000.0 + i + j * 0.1,
                             float(rng.random() * scale)]
                            for j in range(int(rng.integers(1, 5)))],
                 "tombstoned": bool(rng.random() < 0.15)}
                for _ in range(n_series)]
        steps.append(vals)
    return steps


def _series_fn(step):
    def fn(name, tags, window_s):
        rows = step["now"].get(name)
        if rows is None:
            return []
        return [{"name": name, "tags": dict(tags), "source": f"s{i}",
                 "kind": "gauge", **r} for i, r in enumerate(rows)]
    return fn


def test_policy_from_config_and_overrides():
    for kw in ({}, {"min_replicas": 0, "max_replicas": 5,
                    "target_ongoing": 3.0},
               {"window_s": 7.5, "burn_threshold": 0.5}):
        a = jas.AutoscalePolicy.from_config(JConfig(), **kw)
        b = tas.AutoscalePolicy.from_config(TConfig(), **kw)
        _same(dataclasses.asdict(a), dataclasses.asdict(b))
    cfg_kw = {"serve_autoscale_ttft_p95_ms": 0.0, "slo_ttft_p95_s": 0.75,
              "serve_autoscale_max_replicas": 3}
    _same(dataclasses.asdict(jas.AutoscalePolicy.from_config(
              JConfig(**cfg_kw))),
          dataclasses.asdict(tas.AutoscalePolicy.from_config(
              TConfig(**cfg_kw))))
    for bad in ({"min_replicas": -1}, {"max_replicas": 0},
                {"target_ongoing": 0.0}):
        for mod in (jas, tas):
            with pytest.raises(ValueError):
                mod.AutoscalePolicy(**bad)


@pytest.mark.parametrize("mode", ["shadow", "enact"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shadow_autoscaler_decision_records(frozen_clock, mode, seed):
    steps = _series_sequence(seed, 40)
    kw = dict(min_replicas=1, max_replicas=6, window_s=10.0,
              target_ongoing=4.0, target_ttft_p95_ms=800.0,
              burn_threshold=1.0, up_sustain_s=1.5, down_sustain_s=4.0,
              up_cooldown_s=2.0, down_cooldown_s=5.0)
    records = []
    for mod in (jas, tas):
        cur = {"now": {}}
        a = mod.ShadowAutoscaler(mod.AutoscalePolicy(**kw), mode=mode,
                                 series_fn=_series_fn(cur),
                                 emit_events=False)
        rng = np.random.default_rng(seed + 100)
        out = []
        for i, vals in enumerate(steps):
            cur["now"] = vals
            replicas = int(rng.integers(1, 7))
            out.append(a.evaluate(f"dep{seed}", replicas, now=0.7 * i))
        out.append({"decisions": list(a.decisions(f"dep{seed}")),
                    "latest": a.latest(),
                    "recommended": a.recommended(f"dep{seed}")})
        records.append(out)
    _same(records[0], records[1])
    assert any(r.get("changed") for r in records[1][:-1])


def test_window_stats():
    rng = np.random.default_rng(5)
    for _ in range(50):
        rows = [{"points": [[float(t), float(rng.normal())
                             if rng.random() > 0.1 else "x"]
                            for t in range(int(rng.integers(0, 6)))]}
                for _ in range(int(rng.integers(0, 5)))]
        _same(jas.window_stats(rows), tas.window_stats(rows))


# ------------------------------------------------------------------ SLO


def _hist(buckets, boundaries=(0.5, 2.0), tags=None):
    return [{"name": "par_slo_s", "kind": "histogram",
             "tags": dict(tags or {"route": "/x"}),
             "value": float(sum(buckets)), "sum": 1.0,
             "buckets": list(buckets), "boundaries": list(boundaries)}]


def test_slo_monitor_burn_rates_and_quantiles():
    rng = np.random.default_rng(9)
    objs = lambda mod: [
        mod.Objective("p95", "par_slo_s", 0.95, 2.0, window_s=30.0),
        mod.Objective("p50", "par_slo_s", 0.5, 1.5, window_s=30.0),
        mod.Objective("tagged", "par_slo_s", 0.9, 0.5,
                      tags={"route": "/x"}, window_s=30.0),
        mod.Objective("other", "par_slo_s", 0.9, 0.5,
                      tags={"route": "/y"})]
    cum = np.zeros(3)
    seq = []
    for _ in range(25):
        cum = cum + rng.integers(0, 40, 3)
        seq.append(_hist(cum.tolist()))
    out = []
    for mod in (jslo, tslo):
        mon = mod.SloMonitor(objs(mod), rows_fn=lambda: [], export=False,
                             seed=False)
        out.append([mon.evaluate(rows=rows, now=3.0 * i)
                    for i, rows in enumerate(seq)] + [mon.events])
    _same(out[0], out[1])


def test_slo_seeding_from_history():
    now = 2.0e9
    hist = [{"name": "par_slo_s", "kind": "histogram", "tags": {},
             "source": "w1", "boundaries": [0.5, 2.0],
             "tombstoned": False,
             "points": [[now - 40, [10.0, 0.0, 0.0]],
                        [now - 5, [10.0, 5.0, 0.0]]]},
            {"name": "par_slo_s", "kind": "histogram", "tags": {},
             "source": "dead", "boundaries": [0.5, 2.0],
             "tombstoned": True,
             "points": [[now - 40, [0.0, 10.0, 0.0]],
                        [now - 35, [0.0, 30.0, 2.0]]]}]
    out = []
    for mod in (jslo, tslo):
        mon = mod.SloMonitor(
            [mod.Objective("s", "par_slo_s", 0.95, 0.5, window_s=30.0)],
            rows_fn=lambda: _hist([10, 50, 2], tags={}), export=False,
            history_fn=lambda n, t, w: hist)
        out.append([mon.evaluate(now=1.0), mon.evaluate(now=2.0),
                    mon.events])
    _same(out[0], out[1])


# --------------------------------------------------------------- router


class _Aid:
    def __init__(self, b):
        self._b = b

    def binary(self):
        return self._b

    def hex(self):
        return self._b.hex()


class _Replica:
    def __init__(self, b):
        self._actor_id = _Aid(b)


def _handle(mod, policy, **over):
    h = mod.DeploymentHandle("dep")
    h._policy = policy
    h._load_stale_s = over.get("load_stale_s", 5.0)
    h._spill_ongoing = over.get("spill_ongoing", 16.0)
    h._shed_queue_depth = over.get("shed_queue_depth", 3)
    h._shed_retry_after_s = over.get("shed_retry_after_s", 1.5)
    h._affinity_chunk = over.get("affinity_chunk", 8)
    return h


def _fill(h, replicas, rng, clock):
    """Seeded load rows, local in-flight counts, summaries and pin."""
    h._local_inflight = {r._actor_id.binary(): int(rng.integers(0, 6))
                         for r in replicas}
    h._loads = {r._actor_id.hex(): {
        "ongoing": float(rng.integers(0, 30)),
        "queue_depth": float(rng.integers(0, 8)),
        "ts": clock["wall"] - float(rng.random() * 8.0)}
        for r in replicas if rng.random() < 0.8}
    h._loads_ref = (None if rng.random() < 0.5 else
                    (clock["wall"] - float(rng.random()),
                     clock["mono"] - float(rng.random())))
    h._overload_pinned = bool(rng.random() < 0.6)


@pytest.mark.parametrize("policy", ["p2c_local", "p2c_load", "affinity"])
def test_handle_routing_pick_sequence(frozen_clock, policy):
    replicas = [_Replica(bytes([i]) * 8) for i in range(5)]
    prompts = [list(map(int, np.random.default_rng(s).integers(
        0, 256, 3 + s % 20))) for s in range(40)]
    outs = []
    for mod in (japi, tapi):
        h = _handle(mod, policy)
        rng = np.random.default_rng(17)
        random.seed(23)
        seq = []
        for i, p in enumerate(prompts):
            _fill(h, replicas, rng, frozen_clock)
            if policy == "affinity" and i % 3 == 0:
                h._kv_summaries = {
                    r._actor_id.hex(): frozenset(
                        [mod.affinity_key(p, 8).hex()[:16]]
                        if hasattr(mod, "affinity_key") else [])
                    for r in replicas[:2]}
            else:
                h._kv_summaries = {}
            key = h.affinity_key({"prompt_ids": p})
            pick = h._p2c(replicas, key)
            seq.append({
                "key": key.hex() if key else None,
                "pick": pick._actor_id.hex(),
                "rendezvous": mod._rendezvous(
                    key or bytes(8), replicas)._actor_id.hex(),
                "blended": [h._blended(r) for r in replicas],
                "ages": [h._row_age(row) for row in h._loads.values()],
                "shed": h.shed_verdict()})
        outs.append(seq)
    _same(outs[0], outs[1])
    assert len({s["pick"] for s in outs[1]}) > 1


def test_affinity_key_equal_to_prefix_cache():
    from ray_tpu.serve.prefix_cache import affinity_key as jkey
    from ray_tpu_torch.serve.prefix_cache import affinity_key as tkey

    rng = np.random.default_rng(3)
    for n in (1, 7, 8, 9, 64, 300):
        ids = list(map(int, rng.integers(0, 50000, n)))
        for chunk in (8, 16, 64):
            assert jkey(ids, chunk) == tkey(ids, chunk)


# --------------------------------------------------------------- schema


GOOD = [
    {"applications": [{"name": "a", "import_path": "m:x"}]},
    {"http_options": {"host": "0.0.0.0", "port": 9000},
     "applications": [
        {"name": "a", "import_path": "m.sub:app", "route_prefix": "/a",
         "args": {"tag": "t"},
         "deployments": [{"name": "D", "num_replicas": 2,
                          "max_concurrent_queries": 4,
                          "user_config": {"k": 1},
                          "ray_actor_options": {"num_cpus": 1},
                          "autoscaling_config": {"min_replicas": 1}}]},
        {"name": "b", "import_path": "n:y"}]},
]
BAD = [
    {"apps": []},
    {"applications": [{"name": "a", "import_path": "no_colon_here"}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"name": "d", "replicas": 3}]}]},
    {"applications": [{"name": "a", "import_path": "m:x"},
                      {"name": "a", "import_path": "m:y"}]},
    {"applications": [{"import_path": "m:x"}]},
    {"applications": "nope"},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "unknown": 1}]},
]


def _asdict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


@pytest.mark.parametrize("doc", GOOD)
def test_serve_config_from_dict(doc):
    _same(_asdict(jschema.ServeConfig.from_dict(doc)),
          _asdict(tschema.ServeConfig.from_dict(doc)))


@pytest.mark.parametrize("doc", BAD)
def test_serve_config_rejections_match(doc):
    errs = []
    for mod in (jschema, tschema):
        try:
            mod.ServeConfig.from_dict(doc)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 — the type is compared
            errs.append((type(e).__name__, str(e)))
    assert errs[0] == errs[1]
    assert errs[0] is not None


# ---------------------------------------------------- the cluster store


class _Ref:
    def __init__(self, h):
        self._h = h

    def hex(self):
        return self._h


class _Client:
    def __init__(self):
        self.kv = {}
        self.freed = []
        self.n = 0

    def put(self, v, cache_local=True):
        self.n += 1
        assert cache_local is False
        return _Ref(f"{self.n:032x}")

    def kv_get(self, ns, k):
        return self.kv.get((ns, bytes(k)))

    def kv_put(self, ns, k, v):
        self.kv[(ns, bytes(k))] = v

    def kv_del(self, ns, k):
        self.kv.pop((ns, bytes(k)), None)
        return True

    def kv_keys(self, ns, prefix=b""):
        return [k for (n, k) in self.kv if n == ns]

    def free(self, refs):
        self.freed.extend(r.hex() for r in refs)


class _RefType:
    """`api.ObjectRef.from_hex` stand-in for `sweep_cluster`."""

    @staticmethod
    def from_hex(h):
        return _Ref(h)


def _store_script(kvo, api_mod, monkeypatch):
    """One seeded script of donations, withdrawals and sweeps → the
    index rows, freed refs and counters after each step."""
    monkeypatch.setattr(api_mod, "ObjectRef", _RefType)
    client = _Client()
    stores = {d: kvo.ObjectKVStore(client, budget=3, donor=d)
              for d in ("a", "b", "c")}
    rng = np.random.default_rng(31)
    trail = []
    for i in range(40):
        op = rng.random()
        d = "abc"[int(rng.integers(0, 3))]
        st = stores[d]
        key = f"k{int(rng.integers(0, 8))}"
        if op < 0.6:
            meta = kvo.make_meta(key, int(rng.integers(1, 4)), 16, 16,
                                 "fp", d, 1, False)
            meta["ts"] = 1000.0 + i
            out = st.donate(meta, {"k": np.zeros(2), "v": np.ones(2)})
            trail.append(("donate", out))
        elif op < 0.8:
            trail.append(("withdraw", st.withdraw(key)))
        elif op < 0.9:
            live = {x for x in "abc" if rng.random() < 0.6}
            trail.append(("sweep", kvo.sweep_cluster(client, live, None)))
        else:
            trail.append(("ttl", kvo.sweep_cluster(
                client, None, 10.0, now=1000.0 + i)))
        trail.append({
            "index": sorted((k.decode(), json.loads(v))
                            for (ns, k), v in client.kv.items()
                            if ns == kvo.INDEX_NS),
            "freed": list(client.freed),
            "stats": {x: s.stats() for x, s in stores.items()},
            "resolve": st.resolve([f"k{j}" for j in range(8)])})
    return trail


def test_object_store_and_sweep_on_one_fake_client(monkeypatch):
    from ray_tpu import api as jcore
    from ray_tpu_torch import api as tcore

    _same(_store_script(jkvo, jcore, monkeypatch),
          _store_script(tkvo, tcore, monkeypatch))


# ------------------------------------------------------------ handoff


@pytest.mark.parametrize("role,peer,kv,hashes,chunk", [
    ("prefill", "kvd", {"keys": ["aa"], "chunk": 16}, [b"\x01" * 16], 16),
    ("prefill", "kvd", None, [], 16),
    (None, None, {"keys": ["bb"]}, [b"\x02" * 16, b"\x03" * 16], 16),
    ("decode", None, None, [b"\x04" * 16], 0),
])
def test_handoff_record(role, peer, kv, hashes, chunk):
    out = []
    for cls in (JDeployment, TDeployment):
        dep = object.__new__(cls)
        dep._pool_role = role
        dep._pool_peer = peer
        dep.engine = types.SimpleNamespace(prefill_chunk=chunk)
        req = types.SimpleNamespace(kv_handoff=kv, prefix_hashes=hashes)
        out.append(dep._handoff_record(req))
    _same(out[0], out[1])
