"""PyTorch port vs the JAX package: the KV object tier.

Counterpart of tests/test_kv_objects.py, every class of it that runs on
the in-process store: the key/span/meta arithmetic, `LocalKVStore`,
donation (drain export, insert-on-free), the adoption ladder (full,
partial and failed adoption, chaos drops, a donor dying between resolve
and fetch, the local prefix cache beating a shallower page set, a
fingerprint mismatch), the prefill→decode pool handoff, preempt-regrow,
resharding adoption (tp 2→4, 4→2 and tp→1, float and int8, a sharded
donation torn mid-chain) and warm discovery.

Each scenario runs twice, on the JAX engine with its own
``ray_tpu.serve.kv_objects.LocalKVStore`` and chaos module, and on the
port's engine with the port's store and chaos module, from the same
weights (``tiny`` in fp32, carried over by ``ray_tpu_torch._bridge``).
Held exactly equal: the greedy streams, the ``kv_*`` stats of every
engine, and the store's entries (key, depth, n_pages, donor tp). The
payload planes: float planes within 1e-5 + 1e-5 |ref| of the JAX
payload's; int8 planes by the rule of tests/test_torch_quant.py
(`_pools_close`: scale planes equal, codes within one on at most 0.1%
of the elements). The port's payloads are torch CPU tensors. The JAX
resharding side runs on the forced host devices of tests/conftest.py;
the port's mesh is the CPU repeated. The paged kernels' launch
counters stay 0 (the plain versions run on CPU tensors).

Then the cluster half, on the port alone (the JAX package's cluster
and the port's never share a process): the cluster store's
compare-and-delete withdraw on the JAX test's fake client
(``TestObjectStore``; its parity with the JAX store, and
``sweep_cluster``'s, is in tests/test_torch_serve_parity.py), the
payload moved to the host before the put, ``TestEnsureClientAudit`` (3)
and ``TestClusterPoolSplit`` (4, the donor SIGKILL included) on the
port's cluster with ``LLMDeployment(device="cpu")``: streams equal the
in-process port engine's token for token. The global
``llm_kv_transfer`` knob's cases (``TestKnobValidation``) are mirrored
in tests/test_torch_engine_actor.py.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import chaos as jchaos
from ray_tpu.models import gpt as jgpt
from ray_tpu.serve import kv_objects as jkvo
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve import kv_objects as tkvo
from ray_tpu_torch.serve import prefix_cache as tpc
from ray_tpu_torch.serve.llm import LLMEngine

JCFG = jgpt.GPTConfig.tiny(attn_impl="xla", dtype=jnp.float32)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)
CHUNK = 16
PAGE = 16
BASE = dict(n_slots=4, max_len=256, kv_mode="paged", page_size=PAGE,
            prefill_chunk=CHUNK, prefill_token_budget=64, decode_block=4)
KV_STATS = ("kv_donations", "kv_donated_pages", "kv_adoptions",
            "kv_partial_adoptions", "kv_adopted_tokens",
            "kv_adopt_failures", "kv_digest_lookups")


@pytest.fixture(autouse=True)
def _no_launches():
    tpa.reset_launch_counts()
    yield
    for fn in (tpa.paged_attention, tpa.paged_prefill_attention):
        assert (fn.launches, fn.int8_launches) == (0, 0)


class Side:
    """One implementation: its engine, store, chaos module and weights."""

    def __init__(self, name, params):
        self.name = name
        self.jax = name == "jax"
        self.kvo = jkvo if self.jax else tkvo
        self.chaos = jchaos if self.jax else tchaos
        self.params = params

    def engine(self, **kw):
        args = dict(BASE, **kw)
        if self.jax:
            return JaxEngine(JCFG, self.params, **args)
        return LLMEngine(TCFG, self.params, device="cpu", **args)

    def store(self, budget=64):
        return self.kvo.LocalKVStore(budget=budget)


@pytest.fixture(scope="module")
def sides():
    jp = jgpt.init_params(JCFG, jax.random.key(42))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, TCFG,
                         device="cpu")
    return Side("jax", jp), Side("port", tp)


def _drive(eng, reqs, max_steps=2000):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.out_ids for r in reqs]


def _closure(eng):
    acc = eng.page_accounting()
    assert acc["closure"], acc
    assert acc["refs_consistent"], acc
    return acc


def _prompt(seed, n):
    rng = np.random.default_rng(seed)
    return list(map(int, rng.integers(1, JCFG.vocab_size, n)))


def _expected(side, prompt, max_tokens=24, **kw):
    cold = side.engine(**kw)
    return _drive(cold, [cold.submit(prompt, max_tokens=max_tokens)])[0]


def _export_mid_decode(side, prompt, store, *, max_tokens=24, steps=5,
                       **kw):
    """Donor engine: run a stream partway, export it with KV donated."""
    donor = side.engine(kv_transfer=True, kv_store=store, **kw)
    req = donor.submit(prompt, max_tokens=max_tokens, stream=True)
    for _ in range(steps):
        donor.step()
    assert not req.done.is_set(), "stream finished before export"
    conts = donor._export_unfinished()
    assert len(conts) == 1
    _closure(donor)
    return donor, conts[0]


def _resume(side, cont, store, **kw):
    adopter = side.engine(kv_transfer=True, kv_store=store, **kw)
    req = adopter.submit(
        cont["prompt_ids"], max_tokens=cont["max_tokens"],
        generated_ids=cont["generated_ids"], kv=cont.get("kv"),
        prefix_hashes=cont.get("prefix_hashes"),
        prefix_chunk=cont.get("prefix_chunk", 0))
    out = _drive(adopter, [req])[0]
    _closure(adopter)
    return adopter, out


def _kv_stats(eng):
    m = eng.metrics()
    return {k: m[k] for k in KV_STATS}


def _record(streams, store=None, **engines):
    return {"streams": streams, "store": store,
            "stats": {name: _kv_stats(e) for name, e in engines.items()}}


def _entries(store):
    with store._lock:
        return sorted((k, e["meta"]["depth"], e["meta"]["n_pages"],
                       e["meta"]["tp"]) for k, e in store._entries.items())


def _planes_close(name, t, j):
    """One payload plane of the port against the JAX payload's."""
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu", name
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape, (name, tuple(t.shape), j.shape)
    if t.dtype == torch.int8:
        d = np.abs(t.numpy().astype(int) - j.astype(int))
        assert d.max() <= 1 and d.mean() < 1e-3, (name, d.max(), d.mean())
    elif name.endswith("_scale"):
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32), err_msg=name)
    else:
        np.testing.assert_allclose(t.float().numpy(), j.astype(np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def _same(jrec, trec):
    """The port's scenario record equals the JAX one's."""
    assert trec["streams"] == jrec["streams"]
    assert trec["stats"] == jrec["stats"]
    js, ts = jrec["store"], trec["store"]
    if js is None:
        return
    assert _entries(ts) == _entries(js)
    for key, ent in js._entries.items():
        tpay, jpay = ts._entries[key]["payload"], ent["payload"]
        assert sorted(tpay) == sorted(jpay), key
        for name in jpay:
            _planes_close(name, tpay[name], jpay[name])


def _both(sides, run):
    """Run the scenario ``run(side)`` on the JAX engine, then the port's,
    and hold the records equal."""
    jrec, trec = (run(side) for side in sides)
    _same(jrec, trec)
    return jrec, trec


# ------------------------------------------------------------------ units

class TestUnits:
    """Pure key/span/meta arithmetic, against the JAX functions."""

    def test_pages_for_tokens(self):
        for n in (0, 1, 15, 16, 17, 100):
            assert tkvo.pages_for_tokens(n, 16) == jkvo.pages_for_tokens(
                n, 16)
        assert [tkvo.pages_for_tokens(n, 16) for n in (0, 1, 16, 17)] == [
            0, 1, 1, 2]

    def test_page_span_aligned(self):
        assert tkvo.page_span(1, 16, 16) == (0, 1)
        assert tkvo.page_span(3, 16, 16) == (2, 3)
        assert tkvo.page_span(1, 32, 16) == (0, 2)
        assert tkvo.page_span(2, 32, 16) == (2, 4)

    def test_page_span_mid_page_boundary(self):
        spans = [tkvo.page_span(d, 24, 16) for d in (1, 2, 3, 4)]
        assert spans == [jkvo.page_span(d, 24, 16) for d in (1, 2, 3, 4)]
        assert spans == [(0, 2), (2, 3), (3, 5), (5, 6)]
        covered = []
        for s, e in spans:
            assert s == len(covered)
            covered.extend(range(s, e))
        assert len(covered) == tkvo.pages_for_tokens(4 * 24, 16)

    def test_fingerprint_discriminates_and_tags_the_backend(self):
        a = tkvo.engine_fingerprint(TCFG, 16, 16)
        assert a == tkvo.engine_fingerprint(TCFG, 16, 16)
        assert a != tkvo.engine_fingerprint(TCFG, 32, 16)
        assert a != tkvo.engine_fingerprint(TCFG, 16, 32)
        draft = tgpt.GPTConfig.tiny(dtype=torch.float32, n_layers=1)
        assert a != tkvo.engine_fingerprint(TCFG, 16, 16, draft)
        assert a != tkvo.engine_fingerprint(TCFG, 16, 16, kv_dtype="int8")
        # The JAX spelling plus the backend tag, dtype by its plain name.
        jdraft = jgpt.GPTConfig.tiny(dtype=jnp.float32, n_layers=1)
        for t_args, j_args in (((), ()), ((draft,), (jdraft,))):
            for q in ("bf16", "int8"):
                assert tkvo.engine_fingerprint(
                    TCFG, 16, 16, *t_args, kv_dtype=q) == (
                    jkvo.engine_fingerprint(JCFG, 16, 16, *j_args,
                                            kv_dtype=q) + ":torch")
        bf = tgpt.GPTConfig.tiny(dtype=torch.bfloat16)
        assert tkvo.engine_fingerprint(bf, 64, 256) == "2x8x8:bfloat16:ps64:c256:torch"

    def test_make_meta_shape(self):
        m = tkvo.make_meta("ab" * 16, 2, 16, 16, "fp", "donor-1", 1, False)
        j = jkvo.make_meta("ab" * 16, 2, 16, 16, "fp", "donor-1", 1, False)
        assert sorted(m) == sorted(j)
        assert {k: v for k, v in m.items() if k != "ts"} == {
            k: v for k, v in j.items() if k != "ts"}
        assert m["n_tokens"] == 32 and m["ts"] > 0 and m["tp"] == 1


# ------------------------------------------------------------------ store

def _tensors(n=1):
    return {"k": torch.zeros(n), "v": torch.zeros(n)}


class TestLocalStore:
    def test_donate_resolve_fetch_roundtrip(self):
        st = tkvo.LocalKVStore(budget=8)
        payload = {"k": torch.ones((2, 1, 4)), "v": torch.zeros((2, 1, 4))}
        st.donate(tkvo.make_meta("aa", 1, 16, 16, "fp", "d1", 1, False),
                  payload)
        assert set(st.resolve(["aa", "bb"])) == {"aa"}
        got = st.fetch(st.resolve(["aa"])["aa"])
        assert got["k"] is payload["k"]
        assert st.withdraw("aa") and not st.resolve(["aa"])
        with pytest.raises(KeyError, match="gone"):
            st.fetch({"key": "aa"})

    def test_donate_dedups_and_keeps_the_first(self):
        st = tkvo.LocalKVStore(budget=8)
        first = _tensors()
        meta = tkvo.make_meta("aa", 1, 16, 16, "fp", "d1", 1, False)
        st.donate(meta, first)
        again = st.donate(dict(meta, donor="d2"), _tensors())
        assert again["donor"] == "d1" and st.donations == 1
        assert st.fetch(meta)["k"] is first["k"]

    def test_budget_withdraws_oldest(self):
        for kvo, payload in ((tkvo, _tensors), (jkvo, lambda: {
                "k": np.zeros(1), "v": np.zeros(1)})):
            st = kvo.LocalKVStore(budget=2)
            for i in range(4):
                st.donate(kvo.make_meta(f"k{i}", 1, 16, 16, "fp", "d", 1,
                                        False), payload())
            assert set(st.resolve([f"k{i}" for i in range(4)])) == {
                "k2", "k3"}
            assert st.withdrawals == 2
            assert st.stats() == {"entries": 2, "donations": 4,
                                  "withdrawals": 2, "budget": 2}

    def test_withdrawals_counter_guarded_by_lock(self):
        class Probe(tkvo.LocalKVStore):
            def __setattr__(self, name, value):
                if name == "withdrawals" and self.__dict__.get("_probe_on"):
                    self.__dict__.setdefault("locked_at_write", []).append(
                        self._lock.locked())
                object.__setattr__(self, name, value)

        st = Probe(budget=8)
        st._probe_on = True
        for i in range(3):
            st.donate(tkvo.make_meta(f"k{i}", 1, 16, 16, "fp", "d0", 1,
                                     False), _tensors())
        assert st.withdraw("k0")
        assert st.sweep(live_donors=set()) == 2
        assert st.withdrawals == 3
        assert st.locked_at_write and all(st.locked_at_write)

    def test_sweep_dead_donor_and_ttl(self):
        st = tkvo.LocalKVStore(budget=8)
        st.donate(tkvo.make_meta("live", 1, 16, 16, "fp", "alive", 1,
                                 False), _tensors())
        st.donate(tkvo.make_meta("orphan", 1, 16, 16, "fp", "dead", 1,
                                 False), _tensors())
        assert st.sweep(live_donors={"alive"}) == 1
        assert set(st.resolve(["live", "orphan"])) == {"live"}
        assert st.sweep(ttl_s=0.0, now=st.resolve(["live"])["live"]["ts"]
                        + 1) == 1
        assert not st.resolve(["live"])

    def test_fetch_is_the_adopt_chaos_site(self):
        st = tkvo.LocalKVStore(budget=8)
        meta = tkvo.make_meta("aa", 1, 16, 16, "fp", "d1", 1, False)
        st.donate(meta, _tensors())
        tchaos.install([{"site": "serve.kv.adopt", "action": "drop",
                         "count": -1}])
        try:
            with pytest.raises(tchaos.ChaosError):
                st.fetch(meta)
        finally:
            tchaos.uninstall()

    def test_get_store_is_process_global(self, sides):
        tkvo.reset_local_store()
        try:
            a = tkvo.get_store()
            assert a is tkvo.get_store()
            assert isinstance(a, tkvo.LocalKVStore)
            # The budget is the runtime config's, as the reference's.
            from ray_tpu_torch.core.config import runtime_config

            assert a.budget == runtime_config().serve_kv_object_budget == 64
            eng = sides[1].engine(kv_transfer=True)
            assert eng._kv_store is a
            assert eng._kv_donor.startswith("local:")
        finally:
            tkvo.reset_local_store()
        assert tkvo.get_store() is not a
        tkvo.reset_local_store()


# --------------------------------------------------------------- donation

class TestDonation:
    """Drain export donates the written prefix, keyed by the prefix
    cache's chunk-chain digests."""

    def test_export_donates_chain_keyed_pages(self, sides):
        def run(side):
            store = side.store()
            prompt = _prompt(0, 50)
            donor, cont = _export_mid_decode(side, prompt, store)
            desc = cont["kv"]
            written = (prompt + cont["generated_ids"])[:desc["n_tokens"]]
            expect = [h.hex() for h in tpc.chunk_hashes(written, CHUNK)]
            assert desc["keys"] == expect
            assert store.stats()["entries"] == len(expect)
            m = donor.metrics()
            assert m["kv_donations"] == len(expect)
            assert m["kv_donated_pages"] == tkvo.pages_for_tokens(
                desc["n_tokens"], PAGE)
            rec = _record([cont["generated_ids"]], store, donor=donor)
            rec["desc"] = desc
            return rec

        jrec, trec = _both(sides, run)
        jd, td = jrec["desc"], trec["desc"]
        assert td["fingerprint"] == jd["fingerprint"] + ":torch"
        assert {k: v for k, v in td.items() if k != "fingerprint"} == {
            k: v for k, v in jd.items() if k != "fingerprint"}
        for ent in trec["store"]._entries.values():
            for plane in ent["payload"].values():
                assert plane.dtype == torch.float32

    def test_continuation_carries_memoized_hashes(self, sides):
        def run(side):
            store = side.store()
            _donor, cont = _export_mid_decode(side, _prompt(1, 50), store)
            assert cont["prefix_chunk"] == CHUNK and cont["prefix_hashes"]
            adopter = side.engine(kv_transfer=True, kv_store=store)
            calls = {"n": 0}
            real = tpc.hashlib.blake2b

            def counting(*a, **kw):
                calls["n"] += 1
                return real(*a, **kw)

            tpc.hashlib.blake2b = counting
            try:
                req = adopter.submit(
                    cont["prompt_ids"], max_tokens=cont["max_tokens"],
                    generated_ids=cont["generated_ids"], kv=cont["kv"],
                    prefix_hashes=cont["prefix_hashes"],
                    prefix_chunk=cont["prefix_chunk"])
                assert len(req.prefix_hashes) == len(cont["prefix_hashes"])
                out = _drive(adopter, [req])[0]
            finally:
                tpc.hashlib.blake2b = real
            context = cont["prompt_ids"] + cont["generated_ids"]
            assert calls["n"] < len(context) // CHUNK
            rec = _record([out], store, adopter=adopter)
            rec["hashes"] = calls["n"]
            return rec

        jrec, trec = _both(sides, run)
        assert trec["hashes"] == jrec["hashes"]

    def test_wrong_chunk_memo_is_dropped(self, sides):
        def run(side):
            eng = side.engine(kv_transfer=True, kv_store=side.store(4))
            req = eng.submit(_prompt(2, 40), max_tokens=2,
                             prefix_hashes=["ab" * 16],
                             prefix_chunk=CHUNK + 8)
            assert req.prefix_hashes == []
            return _record(_drive(eng, [req]), eng=eng)

        _both(sides, run)

    def test_donation_chaos_raise_keeps_serving(self, sides):
        """serve.kv.donate raise: the donation is skipped, the export
        closes with no in-flight ref left, and the resume re-prefills."""
        def run(side):
            store = side.store()
            side.chaos.install([{"site": "serve.kv.donate",
                                 "action": "raise", "count": -1}])
            try:
                donor, cont = _export_mid_decode(side, _prompt(3, 50),
                                                 store)
            finally:
                side.chaos.uninstall()
            assert _closure(donor)["exporting"] == 0
            assert store.stats()["entries"] == 0
            exp = _expected(side, _prompt(3, 50))
            adopter, out = _resume(side, cont, store)
            assert out == exp
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)

    def test_closure_holds_with_donation_in_flight(self, sides):
        """The pages of a donation in progress (reffed for the gather and
        the put) are the in-flight-donated category: seen from inside the
        store's put, the accounting closes with them counted; the put then
        raises (the donor killed mid-donation) and the refs are
        released."""
        def run(side):
            seen = []

            class Probe(side.kvo.LocalKVStore):
                def donate(self, meta, payload):
                    seen.append(self.engine.page_accounting())
                    raise RuntimeError("donor killed mid-donation")

            store = Probe(budget=64)
            donor = side.engine(kv_transfer=True, kv_store=store)
            store.engine = donor
            req = donor.submit(_prompt(4, 50), max_tokens=24)
            for _ in range(5):
                donor.step()
            conts = donor._export_unfinished()
            assert req.migrated and conts[0]["kv"]["keys"]
            assert len(seen) == 1
            acc = seen[0]
            n_pages = tkvo.pages_for_tokens(conts[0]["kv"]["n_tokens"],
                                            PAGE)
            assert acc["closure"] and acc["refs_consistent"], acc
            assert acc["exporting"] == n_pages and acc["live"] >= n_pages
            after = _closure(donor)
            assert after["exporting"] == 0 and after["free"] == after["total"]
            rec = _record([conts[0]["generated_ids"]], donor=donor)
            rec["mid"] = acc
            return rec

        jrec, trec = _both(sides, run)
        assert trec["mid"] == jrec["mid"]


# ---------------------------------------------------------- adoption ladder

class TestAdoptionLadder:
    """adopt → partial adopt + cold suffix → re-prefill, each the
    uninterrupted stream."""

    def test_full_adoption_byte_identical(self, sides):
        def run(side):
            prompt = _prompt(10, 50)
            exp = _expected(side, prompt)
            store = side.store()
            donor, cont = _export_mid_decode(side, prompt, store)
            adopter, out = _resume(side, cont, store)
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1 and m["kv_adopt_failures"] == 0
            assert m["kv_adopted_tokens"] == cont["kv"]["n_tokens"]
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)

    def test_partial_adoption_when_deep_entries_gone(self, sides):
        def run(side):
            prompt = _prompt(11, 60)
            exp = _expected(side, prompt)
            store = side.store()
            _donor, cont = _export_mid_decode(side, prompt, store)
            keys = cont["kv"]["keys"]
            assert len(keys) >= 3
            for k in keys[2:]:
                store.withdraw(k)
            adopter, out = _resume(side, cont, store)
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1
            assert m["kv_adopted_tokens"] == 2 * CHUNK
            return _record([exp, out], store, adopter=adopter)

        _both(sides, run)

    def test_all_entries_gone_falls_to_reprefill(self, sides):
        def run(side):
            prompt = _prompt(12, 50)
            exp = _expected(side, prompt)
            store = side.store()
            _donor, cont = _export_mid_decode(side, prompt, store)
            store.sweep(live_donors=set())
            adopter, out = _resume(side, cont, store)
            assert out == exp
            assert adopter.metrics()["kv_adoptions"] == 0
            return _record([exp, out], store, adopter=adopter)

        _both(sides, run)

    def test_chaos_dropped_transfer_engages_fallback(self, sides):
        def run(side):
            prompt = _prompt(13, 50)
            exp = _expected(side, prompt)
            store = side.store()
            _donor, cont = _export_mid_decode(side, prompt, store)
            side.chaos.install([{"site": "serve.kv.adopt", "action": "drop",
                                 "count": -1}])
            try:
                adopter, out = _resume(side, cont, store)
            finally:
                side.chaos.uninstall()
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 0 and m["kv_adopt_failures"] >= 1
            return _record([exp, out], store, adopter=adopter)

        _both(sides, run)

    def test_chaos_dropped_tail_is_partial_adoption(self, sides):
        def run(side):
            prompt = _prompt(14, 60)
            exp = _expected(side, prompt)
            store = side.store()
            _donor, cont = _export_mid_decode(side, prompt, store)
            side.chaos.install([{"site": "serve.kv.adopt", "action": "drop",
                                 "after": 1, "count": -1}])
            try:
                adopter, out = _resume(side, cont, store)
            finally:
                side.chaos.uninstall()
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1 and m["kv_partial_adoptions"] == 1
            assert m["kv_adopted_tokens"] == CHUNK
            return _record([exp, out], store, adopter=adopter)

        _both(sides, run)

    def test_donor_dies_mid_adoption(self, sides):
        def run(side):
            prompt = _prompt(15, 60)
            exp = _expected(side, prompt)

            class DyingDonorStore(side.kvo.LocalKVStore):
                fetches = 0

                def fetch(self, meta, timeout=30.0):
                    self.fetches += 1
                    if self.fetches == 2:
                        with self._lock:
                            self._entries.clear()
                    return super().fetch(meta, timeout)

            store = DyingDonorStore(budget=64)
            _donor, cont = _export_mid_decode(side, prompt, store)
            adopter, out = _resume(side, cont, store)
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1 and m["kv_partial_adoptions"] == 1
            return _record([exp, out], store, adopter=adopter)

        _both(sides, run)

    def test_local_prefix_cache_beats_shallower_kv(self, sides):
        def run(side):
            prompt = _prompt(16, 60)
            store = side.store()
            _donor, cont = _export_mid_decode(side, prompt, store)
            for k in cont["kv"]["keys"][1:]:
                store.withdraw(k)
            adopter = side.engine(kv_transfer=True, kv_store=store,
                                  prefix_cache=True)
            exp = _drive(adopter, [adopter.submit(prompt,
                                                  max_tokens=24)])[0]
            r2 = adopter.submit(cont["prompt_ids"],
                                max_tokens=cont["max_tokens"],
                                generated_ids=cont["generated_ids"],
                                kv=cont["kv"])
            out = _drive(adopter, [r2])[0]
            m = adopter.metrics()
            assert m["kv_adoptions"] == 0 and m["prefix_hits"] >= 1
            assert out == exp
            _closure(adopter)
            rec = _record([exp, out], store, adopter=adopter)
            rec["hits"] = m["prefix_hits"]
            return rec

        jrec, trec = _both(sides, run)
        assert trec["hits"] == jrec["hits"]

    def test_fingerprint_mismatch_never_adopts(self, sides):
        def run(side):
            prompt = _prompt(17, 50)
            store = side.store()
            _donor, cont = _export_mid_decode(side, prompt, store)
            bad = dict(cont, kv=dict(cont["kv"], fingerprint="other"))
            adopter, out = _resume(side, bad, store)
            assert adopter.metrics()["kv_adoptions"] == 0
            assert out == _expected(side, prompt)
            return _record([out], store, adopter=adopter)

        _both(sides, run)

    def test_jax_page_sets_never_adopted_by_the_port(self, sides):
        """A JAX donor's entries (its fingerprint has no backend tag),
        copied into the port's store with their payloads as tensors: a
        port engine resuming the JAX continuation never adopts them,
        neither on the descriptor (pre-screened, no index lookup) nor on a
        discover hint (resolved, refused entry by entry), and its stream
        is the uninterrupted one."""
        jside, tside = sides
        prompt = _prompt(18, 50)
        jstore = jside.store()
        _donor, cont = _export_mid_decode(jside, prompt, jstore)
        tstore = tside.store()
        for ent in jstore._entries.values():
            assert not ent["meta"]["fingerprint"].endswith(":torch")
            tstore.donate(ent["meta"], {
                k: torch.from_numpy(np.array(v, np.float32))
                for k, v in ent["payload"].items()})
        exp = _expected(tside, prompt)
        adopter, out = _resume(tside, cont, tstore)
        assert out == exp
        m = adopter.metrics()
        assert m["kv_adoptions"] == 0 and m["kv_digest_lookups"] == 0
        hinted = dict(cont, kv={"discover": True})
        adopter, out = _resume(tside, hinted, tstore)
        assert out == exp
        m = adopter.metrics()
        assert m["kv_adoptions"] == 0 and m["kv_digest_lookups"] == 1
        assert m["kv_adopt_failures"] == 0


# ------------------------------------------------------------ pool handoff

class TestPoolHandoff:
    """pool_role='prefill': first token here, decode elsewhere."""

    def test_prefill_engine_hands_off_after_first_token(self, sides):
        def run(side):
            store = side.store()
            pre = side.engine(pool_role="prefill", kv_store=store)
            req = pre.submit(_prompt(20, 50), max_tokens=24, stream=True)
            _drive(pre, [req], max_steps=50)
            assert req.migrated and len(req.out_ids) == 1
            assert req.kv_handoff and req.kv_handoff["keys"]
            streamed = []
            while (t := req.stream.get(timeout=5)) is not None:
                streamed.append(t)
            assert streamed == req.out_ids
            assert _closure(pre)["exporting"] == 0
            snap = pre.load_snapshot()
            assert snap["pool_role"] == "prefill"
            assert pre.metrics()["pool_role"] == "prefill"
            return _record([req.out_ids], store, pre=pre)

        _both(sides, run)

    def test_handoff_resume_byte_identical(self, sides):
        def run(side):
            prompt = _prompt(21, 50)
            exp = _expected(side, prompt)
            store = side.store()
            pre = side.engine(pool_role="prefill", kv_store=store)
            req = pre.submit(prompt, max_tokens=24, stream=True)
            _drive(pre, [req], max_steps=50)
            dec = side.engine(pool_role="decode", kv_store=store)
            r2 = dec.submit(prompt, max_tokens=24,
                            generated_ids=list(req.out_ids),
                            kv=req.kv_handoff,
                            prefix_hashes=[h.hex()
                                           for h in req.prefix_hashes],
                            prefix_chunk=CHUNK)
            out = _drive(dec, [r2])[0]
            assert out == exp
            m = dec.metrics()
            assert m["kv_adoptions"] == 1
            # The decode pool frees adopted pages it did not produce
            # without donating them.
            assert m["kv_donations"] == 0
            # Only the cold tail is prefilled.
            assert m["prefill_tokens"] == (len(prompt) + 1
                                           - m["kv_adopted_tokens"])
            _closure(dec)
            return _record([exp, out], store, pre=pre, dec=dec)

        _both(sides, run)

    def test_one_token_prompt_budget_finishes_without_handoff(self, sides):
        def run(side):
            pre = side.engine(pool_role="prefill", kv_store=side.store(8))
            req = pre.submit(_prompt(22, 40), max_tokens=1)
            _drive(pre, [req], max_steps=50)
            assert not req.migrated and len(req.out_ids) == 1
            return _record([req.out_ids], pre=pre)

        _both(sides, run)


# ---------------------------------------------------------- preempt-regrow

class TestPreemptRegrow:
    """context == prompt_ids[:n_prompt] + out_ids across repeated
    preempts, and donations keyed by the sequence the pages hold."""

    @staticmethod
    def _force_preempt(eng, req):
        slot = next(s for s, r in enumerate(eng.slot_req) if r is req)
        eng._preempt(slot)

    def test_double_preempt_context_and_stream_exact(self, sides):
        def run(side):
            prompt = _prompt(60, 40)
            exp = _expected(side, prompt, max_tokens=40)
            eng = side.engine()
            req = eng.submit(prompt, max_tokens=40)
            for _ in range(3):
                eng.step()
            self._force_preempt(eng, req)
            assert req.prompt_ids == prompt + req.out_ids
            for _ in range(5):
                eng.step()
            self._force_preempt(eng, req)
            assert req.prompt_ids == prompt + req.out_ids
            out = _drive(eng, [req])[0]
            assert out == exp
            _closure(eng)
            return _record([exp, out], eng=eng)

        _both(sides, run)

    def test_donation_after_preempt_keys_true_sequence(self, sides):
        def run(side):
            store = side.store()
            prompt = _prompt(61, 40)
            eng = side.engine(kv_transfer=True, kv_store=store,
                              prefix_cache=True)
            req = eng.submit(prompt, max_tokens=40, stream=True)
            for _ in range(4):
                eng.step()
            self._force_preempt(eng, req)
            for _ in range(4):
                eng.step()
            conts = eng._export_unfinished()
            assert conts and conts[0]["kv"]
            true_written = (prompt + req.out_ids)[
                :conts[0]["kv"]["n_tokens"]]
            assert conts[0]["kv"]["keys"] == [
                h.hex() for h in tpc.chunk_hashes(true_written, CHUNK)]
            _closure(eng)
            return _record([req.out_ids], store, eng=eng)

        _both(sides, run)


# ------------------------------------------------------- resharding adoption

class TestReshardingAdoption:
    """tp > 1 donors publish per-shard head planes (``k@s``); an adopter
    at another degree joins and re-slices them at bind time."""

    pytestmark = pytest.mark.skipif(
        len(jax.devices()) < 4,
        reason="resharding tests need >= 4 (virtual) devices")

    @pytest.mark.parametrize("donor_tp,adopter_tp", [(2, 4), (4, 2)])
    @pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
    def test_reshard_byte_exact(self, sides, donor_tp, adopter_tp,
                                attn_impl):
        def run(side):
            prompt = _prompt(70, 50)
            exp = _expected(side, prompt, attn_impl=attn_impl)
            store = side.store()
            donor, cont = _export_mid_decode(
                side, prompt, store, attn_impl=attn_impl, tp=donor_tp)
            metas = store.resolve(cont["kv"]["keys"])
            assert metas and all(m["tp"] == donor_tp
                                 for m in metas.values())
            p = store.fetch(next(iter(metas.values())))
            assert f"k@{donor_tp - 1}" in p and "k" not in p
            adopter, out = _resume(side, cont, store, attn_impl=attn_impl,
                                   tp=adopter_tp)
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1 and m["kv_adopt_failures"] == 0
            assert m["kv_adopted_tokens"] == cont["kv"]["n_tokens"]
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)

    @pytest.mark.parametrize("donor_tp,adopter_tp", [(2, 4), (4, 2)])
    def test_reshard_int8_scale_planes(self, sides, donor_tp, adopter_tp):
        def run(side):
            prompt = _prompt(71, 50)
            exp = _expected(side, prompt, kv_dtype="int8")
            store = side.store()
            donor, cont = _export_mid_decode(
                side, prompt, store, kv_dtype="int8", tp=donor_tp)
            p = store.fetch(next(iter(store.resolve(
                cont["kv"]["keys"]).values())))
            assert f"k@{donor_tp - 1}" in p
            assert "k_scale" in p and "k_scale@0" not in p
            adopter, out = _resume(side, cont, store, kv_dtype="int8",
                                   tp=adopter_tp)
            assert out == exp
            assert adopter.metrics()["kv_adoptions"] == 1
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)

    @pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
    def test_tp_donor_to_tp1_adopter(self, sides, kv_dtype):
        def run(side):
            prompt = _prompt(73, 50)
            exp = _expected(side, prompt, kv_dtype=kv_dtype)
            store = side.store()
            donor, cont = _export_mid_decode(side, prompt, store, tp=2,
                                             kv_dtype=kv_dtype)
            adopter, out = _resume(side, cont, store, kv_dtype=kv_dtype)
            assert out == exp
            assert adopter.metrics()["kv_adoptions"] == 1
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)

    def test_tp1_donor_to_tp2_adopter_pool_bits(self, sides):
        """The port alone: after a tp=1 → tp=2 adoption the adopted pages
        of the two shards, joined on the head axis, are the donated
        payload bit for bit."""
        tside = sides[1]
        store = tside.store()
        donor, cont = _export_mid_decode(tside, _prompt(74, 50), store)
        adopter = tside.engine(kv_transfer=True, kv_store=store, tp=2)
        req = adopter.submit(cont["prompt_ids"],
                             max_tokens=cont["max_tokens"],
                             generated_ids=cont["generated_ids"],
                             kv=cont["kv"])
        adopter._admit()    # admission binds the adopted pages
        assert adopter.metrics()["kv_adoptions"] == 1
        slot = next(s for s, r in enumerate(adopter.slot_req) if r is req)
        metas = [store.resolve([k])[k] for k in cont["kv"]["keys"]]
        n_pages = sum(m["n_pages"] for m in metas)
        pages = torch.from_numpy(adopter.page_table[slot, :n_pages].astype(
            np.int64))
        for name in ("k", "v"):
            sent = torch.cat([store.fetch(m)[name] for m in metas], dim=1)
            got = torch.cat([shard[name][:, pages] for shard in
                             adopter.cache], dim=3)
            assert torch.equal(got, sent), name
        _drive(adopter, [req])
        _closure(adopter)

    def test_donor_dies_mid_sharded_donation_index_consistent(self, sides):
        def run(side):
            prompt = _prompt(72, 60)
            exp = _expected(side, prompt)

            class DyingDonorStore(side.kvo.LocalKVStore):
                calls = 0

                def donate(self, meta, payload):
                    self.calls += 1
                    if self.calls > 2:
                        raise RuntimeError("donor SIGKILLed mid-donation")
                    return super().donate(meta, payload)

            store = DyingDonorStore(budget=64)
            donor, cont = _export_mid_decode(side, prompt, store, tp=2)
            assert _closure(donor)["exporting"] == 0
            keys = cont["kv"]["keys"]
            assert len(keys) >= 3 and store.calls > 2
            metas = store.resolve(keys)
            assert set(metas) == set(keys[:2])
            for meta in metas.values():
                assert {"k@0", "k@1"} <= set(store.fetch(meta))
            adopter, out = _resume(side, cont, store, tp=4)
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1 and m["kv_adopt_failures"] == 0
            assert m["kv_adopted_tokens"] == 2 * CHUNK
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)


# ------------------------------------------------------------ warm discovery

class TestWarmDiscovery:
    """Donated chain heads ride load_snapshot() as a bounded summary, and
    a ``kv={"discover": True}`` hint lets the adopt plan resolve the
    request's own chain without a descriptor."""

    @staticmethod
    def _head(prompt):
        return tpc.chunk_hashes(prompt[:CHUNK], CHUNK)[0].hex()[:16]

    def test_completion_donates_and_populates_summary(self, sides):
        def run(side):
            store = side.store()
            donor = side.engine(kv_transfer=True, kv_store=store)
            prompt = _prompt(80, 50)
            out = _drive(donor, [donor.submit(prompt, max_tokens=24)])
            assert store.stats()["entries"] > 0
            snap = donor.load_snapshot()
            assert self._head(prompt) in snap["kv_summary"]
            assert snap["pool_role"] == "fused"
            m = donor.metrics()
            assert m["kv_transfer"] is True and m["pool_role"] == "fused"
            assert m["kv_summary_entries"] == len(snap["kv_summary"])
            assert m["kv_summary_max"] > 0
            _closure(donor)
            # A second completion of the chain is memo-gated: no resolve,
            # no new donation.
            _drive(donor, [donor.submit(prompt, max_tokens=24)])
            assert donor.metrics()["kv_donations"] == m["kv_donations"]
            rec = _record(out, store, donor=donor)
            rec["snap"] = {k: snap[k] for k in (
                "kv_summary", "kv_donations", "kv_adoptions",
                "kv_partial_adoptions", "kv_adopted_tokens",
                "kv_adopt_failures", "kv_digest_lookups")}
            return rec

        jrec, trec = _both(sides, run)
        assert trec["snap"] == jrec["snap"]

    def test_discover_hint_adopts_without_descriptor(self, sides):
        def run(side):
            prompt = _prompt(81, 50)
            exp = _expected(side, prompt)
            store = side.store()
            donor = side.engine(kv_transfer=True, kv_store=store)
            _drive(donor, [donor.submit(prompt, max_tokens=24)])
            adopter = side.engine(kv_transfer=True, kv_store=store)
            req = adopter.submit(prompt, max_tokens=24,
                                 kv={"discover": True})
            out = _drive(adopter, [req])[0]
            assert out == exp
            m = adopter.metrics()
            assert m["kv_adoptions"] == 1 and m["kv_digest_lookups"] == 1
            assert m["kv_adopted_tokens"] == (len(prompt) // CHUNK) * CHUNK
            _closure(adopter)
            return _record([exp, out], store, donor=donor, adopter=adopter)

        _both(sides, run)

    def test_unhinted_request_never_touches_index(self, sides):
        def run(side):
            prompt = _prompt(82, 50)
            store = side.store()
            donor = side.engine(kv_transfer=True, kv_store=store)
            _drive(donor, [donor.submit(prompt, max_tokens=24)])
            adopter = side.engine(kv_transfer=True, kv_store=store)
            out = _drive(adopter, [adopter.submit(prompt, max_tokens=24)])
            m = adopter.metrics()
            assert m["kv_digest_lookups"] == 0 and m["kv_adoptions"] == 0
            return _record(out, store, donor=donor, adopter=adopter)

        _both(sides, run)

    def test_discover_false_positive_falls_through(self, sides):
        def run(side):
            prompt = _prompt(83, 50)
            exp = _expected(side, prompt)
            adopter = side.engine(kv_transfer=True, kv_store=side.store())
            req = adopter.submit(prompt, max_tokens=24,
                                 kv={"discover": True})
            out = _drive(adopter, [req])[0]
            assert out == exp
            m = adopter.metrics()
            assert m["kv_digest_lookups"] == 1 and m["kv_adoptions"] == 0
            return _record([exp, out], adopter=adopter)

        _both(sides, run)

    def test_summary_bounded_newest_kept(self, sides):
        def run(side):
            eng = side.engine(kv_transfer=True, kv_store=side.store(8))
            eng._kv_summary_max = 3
            for i in range(5):
                eng._kv_note_donation(f"h{i}", 1)
            assert list(eng._kv_donated) == ["h2", "h3", "h4"]
            eng._kv_note_donation("h2", 4)
            eng._kv_note_donation("h2", 2)
            assert list(eng._kv_donated) == ["h3", "h4", "h2"]
            assert eng._kv_donated["h2"] == 4
            assert eng.load_snapshot()["kv_summary"] == ["h3", "h4", "h2"]
            return _record([list(eng._kv_donated.items())], eng=eng)

        _both(sides, run)


# ------------------------------------------------------------ validation

class TestKnobValidation:
    """The JAX engine's explicit-argument errors, raised by both."""

    def test_kv_transfer_explicit_requires_paged_chunked(self, sides):
        for side in sides:
            with pytest.raises(ValueError, match="page-set transfer"):
                side.engine(kv_mode="dense", prefill_chunk=0,
                            kv_transfer=True)
            with pytest.raises(ValueError, match="page-set transfer"):
                side.engine(prefill_chunk=0, kv_transfer=True,
                            prefill_token_budget=0)

    def test_kv_transfer_requires_page_aligned_chunks(self, sides):
        for side in sides:
            with pytest.raises(ValueError, match="page-set transfer"):
                side.engine(prefill_chunk=24, kv_transfer=True)

    def test_pool_role_validation(self, sides):
        for side in sides:
            with pytest.raises(ValueError, match="pool_role"):
                side.engine(pool_role="both")
            with pytest.raises(ValueError, match="requires kv_transfer"):
                side.engine(pool_role="prefill", kv_transfer=False)
            with pytest.raises(ValueError, match="page-set transfer"):
                side.engine(kv_mode="dense", prefill_chunk=0,
                            pool_role="prefill")

    def test_roles_turn_transfer_on_and_off_is_the_default(self, sides):
        for side in sides:
            for role in ("prefill", "decode"):
                eng = side.engine(pool_role=role, kv_store=side.store(4))
                assert eng.kv_transfer is True and eng.pool_role == role
            eng = side.engine(kv_store=side.store(4))
            assert eng.kv_transfer is False and eng._kv_store is None
            assert "kv_transfer" not in eng.metrics()
            assert "kv_summary" not in eng.load_snapshot()


# ------------------------------------------------------ the cluster half


class FakeRef:
    def __init__(self, h):
        self._h = h

    def hex(self):
        return self._h


class FakeClient:
    """The JAX test's fake client (tests/test_kv_objects.py), recording
    every payload it is asked to put."""

    def __init__(self):
        self.kv = {}
        self.freed = []
        self.puts = []
        self.n = 0

    def put(self, v, cache_local=True):
        self.n += 1
        self.puts.append((v, cache_local))
        return FakeRef(f"{self.n:032x}")

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


class TestObjectStore:
    def test_withdraw_is_compare_and_delete(self):
        """A donor withdrawing its own STALE donation (its index row
        already swept and re-published by another donor) must not
        delete the other donor's live row."""
        client = FakeClient()
        a = tkvo.ObjectKVStore(client, budget=8, donor="a")
        b = tkvo.ObjectKVStore(client, budget=8, donor="b")
        meta = tkvo.make_meta("kk", 1, 16, 16, "fp", "a", 1, False)
        payload = {"k": torch.zeros(1), "v": torch.zeros(1)}
        a.donate(meta, payload)
        client.kv_del(tkvo.INDEX_NS, b"kk")
        b.donate(tkvo.make_meta("kk", 1, 16, 16, "fp", "b", 1, False),
                 payload)
        live = json.loads(client.kv_get(tkvo.INDEX_NS, b"kk"))
        a.withdraw("kk")
        after = client.kv_get(tkvo.INDEX_NS, b"kk")
        assert after is not None, "A's withdraw deleted B's live row"
        assert json.loads(after)["ref"] == live["ref"]
        assert client.freed, "A's own object must still be freed"
        # The shared-memory extent is the only copy.
        assert all(cache_local is False for _, cache_local in client.puts)

    def test_budget_from_runtime_config_and_donor(self, monkeypatch):
        """get_store takes the cluster branch only with a client
        attached, with the runtime config's budget and the engine's
        donor id."""
        from ray_tpu_torch import api as tapi
        from ray_tpu_torch.core.config import runtime_config

        client = FakeClient()
        monkeypatch.setattr(tapi, "_client", client)
        st = tkvo.get_store(donor="abc")
        assert isinstance(st, tkvo.ObjectKVStore)
        assert st.budget == runtime_config().serve_kv_object_budget
        assert st.donor == "abc" and st._client is client
        assert tkvo.get_store(budget=3).budget == 3

    def test_donated_payload_is_on_the_host_before_the_put(
            self, sides, monkeypatch):
        """`_kv_payload` moves every gathered plane to the host before
        the store sees it: a CUDA tensor nested in the payload dict
        would keep torch's own pickling and come back on its device in
        another process. Pinned by a gather whose planes record their
        `.cpu()`; the store's puts hold only CPU tensors."""
        import ray_tpu_torch.models.paged_kv as pk

        moved = []

        class Plane:
            def __init__(self, a):
                self.a = a

            def cpu(self):
                moved.append(tuple(self.a.shape))
                return self.a.cpu()

        real = pk.gather_pages
        monkeypatch.setattr(pk, "gather_pages", lambda pool, ids: {
            k: Plane(a) for k, a in real(pool, ids).items()})
        client = FakeClient()
        store = tkvo.ObjectKVStore(client, budget=64, donor="d")
        eng = sides[1].engine(kv_transfer=True, kv_store=store)
        assert eng._rt is pk
        _drive(eng, [eng.submit(_prompt(3, 40), max_tokens=4)])
        assert moved, "no donation gathered"
        assert client.puts
        for payload, _ in client.puts:
            for plane in payload.values():
                assert isinstance(plane, torch.Tensor)
                assert plane.device.type == "cpu"


class TestEnsureClientAudit:
    """Client-adjacent constructors never auto-boot a cluster
    (`_ensure_client` gates on `_client is not None`): mirrors the JAX
    class case for case. Each case detaches any client an earlier test
    of the process left attached (restored after), where the JAX class
    skips."""

    @pytest.fixture(autouse=True)
    def _detached(self, monkeypatch):
        from ray_tpu_torch import api as _api

        monkeypatch.setattr(_api, "_client", None)

    def _assert_no_client(self):
        from ray_tpu_torch import api as _api

        assert _api._client is None, \
            "a unit-test path auto-booted a cluster"

    def test_handle_and_push_paths_stay_clusterless(self):
        from ray_tpu_torch import api as _api
        from ray_tpu_torch.serve import api as sapi

        assert _api._client is None
        h = sapi.DeploymentHandle("nonexistent")
        assert sapi._pushed_version() == sapi._push_state["version"]
        sapi._dead_actors()
        assert h._alive([]) == []
        self._assert_no_client()

    def test_state_queries_raise_instead_of_booting(self):
        from ray_tpu_torch import api as _api
        from ray_tpu_torch import state

        assert _api._client is None
        with pytest.raises(RuntimeError, match="running cluster"):
            state.list_nodes()
        assert state.emit_cluster_event("t", "m") is False
        self._assert_no_client()

    def test_kv_store_selection_stays_clusterless(self, sides):
        from ray_tpu_torch import api as _api

        assert _api._client is None
        tkvo.reset_local_store()
        eng = sides[1].engine(kv_transfer=True)
        assert isinstance(eng._kv_store, tkvo.LocalKVStore)
        self._assert_no_client()
        tkvo.reset_local_store()


sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class TestClusterPoolSplit:
    """The live disaggregated stack on the port's cluster: a prefill
    pool and a decode pool behind the proxy, page-set handoff and
    adoption through the cluster store end to end, and the donor
    SIGKILL mid-run (mirrors the JAX class)."""

    N_SLOTS = 4
    MAX_LEN = 256
    MAX_TOKENS = 16
    ENGINE_KW = {"kv_mode": "paged", "page_size": 16,
                 "prefill_chunk": 16, "prefill_token_budget": 64,
                 "decode_block": 4}

    @pytest.fixture(scope="class")
    def stack(self):
        import ray_tpu_torch
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.llm import LLMDeployment

        ray_tpu_torch.init(num_cpus=6, _system_config={
            "serve_kv_sweep_interval_s": 2.0,
            "serve_kv_object_ttl_s": 60.0,
        })
        try:
            decode = serve.deployment(
                LLMDeployment, name="kvd", pool_role="decode").options(
                num_replicas=1, route_prefix=None).bind(
                "tiny", n_slots=self.N_SLOTS, max_len=self.MAX_LEN,
                device="cpu", pool_role="decode",
                engine_kwargs=dict(self.ENGINE_KW))
            prefill = serve.deployment(
                LLMDeployment, name="kvp", pool_role="prefill").options(
                num_replicas=2, route_prefix="/kv").bind(
                "tiny", n_slots=self.N_SLOTS, max_len=self.MAX_LEN,
                device="cpu", pool_role="prefill", pool_peer="kvd",
                engine_kwargs=dict(self.ENGINE_KW))
            serve.run(decode, timeout=300.0)
            serve.run(prefill, timeout=300.0)
            _proxy, port = serve.start_proxy()
            yield port
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()

    def _expected(self, prompts):
        # The replicas' model: "tiny" from the engine's seed.
        eng = LLMEngine(tgpt.GPTConfig.by_name("tiny"), None,
                        n_slots=self.N_SLOTS, max_len=self.MAX_LEN,
                        device="cpu", **self.ENGINE_KW)
        out = []
        for p in prompts:
            req = eng.submit(p, max_tokens=self.MAX_TOKENS)
            while not req.done.is_set():
                eng.step()
            out.append(list(req.out_ids))
        return out

    def _decode_load(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import _get_controller

        ctrl = _get_controller()
        load = ray_tpu_torch.get(ctrl.get_load.remote(), timeout=30)
        rows = load.get("kvd", {}).get("replicas", [])
        return (rows[0].get("load") or {}) if rows else {}

    def test_stream_handoff_adopts_byte_exact(self, stack):
        import bench_chaos

        port = stack
        prompts = [_prompt(30 + i, 48) for i in range(4)]
        expected = self._expected(prompts)
        for i, p in enumerate(prompts):
            r = bench_chaos._sse_stream(port, "/kv", {
                "prompt_ids": p, "max_tokens": self.MAX_TOKENS},
                timeout_s=300)
            assert r["error"] is None and r["done"], r["error"]
            assert r["tokens"] == expected[i], (i, r["tokens"])
        deadline = time.time() + 15
        while time.time() < deadline:
            eng = self._decode_load()
            if eng.get("kv_adoptions", 0) >= 1:
                break
            time.sleep(0.5)
        assert eng.get("pool_role") == "decode"
        assert eng.get("kv_adoptions", 0) >= 1, eng

    def test_unary_handoff_through_proxy(self, stack):
        import urllib.request

        port = stack
        prompt = _prompt(40, 48)
        exp = self._expected([prompt])[0]
        body = json.dumps({"prompt_ids": prompt,
                           "max_tokens": self.MAX_TOKENS}).encode()
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/kv", data=body, timeout=300)
        out = json.loads(r.read())["result"]
        assert out["output_ids"] == exp, out

    def test_summary_and_push_bytes_ride_routing_table(self, stack):
        """Donated chain heads reach handles through the routing push
        itself: kv_summary in the per-replica load rows, push_bytes
        accounted in-band."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import _get_controller

        _ = stack   # the handoff tests above already drove donations
        ctrl = _get_controller()
        heads = []
        deadline = time.time() + 30
        while time.time() < deadline:
            table = ray_tpu_torch.get(ctrl.get_routing.remote(-1),
                                      timeout=30)
            assert table["push_bytes"] > 0
            rows = table["routes"]["kvp"]["loads"]
            heads = [h for row in rows.values()
                     for h in row.get("kv_summary", ())]
            if heads:
                break
            time.sleep(0.5)
        assert heads, "no kv_summary ever rode the routing push"
        assert all(isinstance(h, str) and len(h) == 16 for h in heads)

    def test_donor_sigkill_mid_donation_zero_drop(self, stack):
        """A prefill replica SIGKILLed INSIDE a donation (chaos kill at
        serve.kv.donate): in-flight streams fail over and complete with
        0 dropped / 0 mismatched tokens, and the decode engine's page
        accounting closes afterwards."""
        import bench_chaos
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import _get_controller

        port = stack
        prompts = [_prompt(50 + i, 48) for i in range(6)]
        expected = self._expected(prompts)
        ctrl = _get_controller()
        table = ray_tpu_torch.get(ctrl.get_routing.remote(-1), timeout=30)
        victim = table["routes"]["kvp"]["replicas"][0]
        ray_tpu_torch.get(victim.install_chaos.remote(
            [{"site": "serve.kv.donate", "action": "kill", "after": 1}]),
            timeout=30)
        results = [None] * len(prompts)

        def client(i):
            results[i] = bench_chaos._sse_stream(port, "/kv", {
                "prompt_ids": prompts[i],
                "max_tokens": self.MAX_TOKENS}, timeout_s=300)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        dropped = [i for i, r in enumerate(results)
                   if r is None or r["error"] or not r["done"]]
        assert not dropped, [results[i] and results[i]["error"]
                             for i in dropped]
        mismatched = [i for i, r in enumerate(results)
                      if r["tokens"] != expected[i]]
        assert not mismatched, mismatched
        rows = ray_tpu_torch.get(ctrl.get_routing.remote(-1),
                                 timeout=30)["routes"]["kvd"]["replicas"]
        acc = ray_tpu_torch.get(rows[0].handle_request.remote(
            "page_accounting", (), {}), timeout=60)
        assert acc["closure"] and acc["refs_consistent"], acc
