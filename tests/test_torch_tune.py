"""Tune of the port (ray_tpu_torch.tune) against the JAX package's.

Mirrors ``tests/test_tune.py`` and ``tests/test_tune_widen.py`` test for
test on the port's runtime, with toy trainables on ``device="cpu"``, on
one module-scoped cluster. Then the parity cases, without a cluster:
the JAX package's module and the port's take the same inputs and must
give the same outputs exactly (no tolerance: the variants, decisions and
suggestions come from the same seeded ``random.Random`` draws and the
same numpy float64 GP, so every float is the same bit for bit):
``BasicVariantGenerator`` variants; ASHA, HyperBand, MedianStopping, PBT
and PB2 decisions on one seeded report sequence; Random, TPE, BayesOpt
and BOHB suggestions from one seeded history. Last, the port's own
rules: a trial takes the Tuner's device (the default raises without a
GPU) and a checkpoint holding a tensor resumes.
"""

import math
import os
import random
import sys
import threading
import types

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu_torch import tune
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune import (
    ASHAScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    RandomSearcher,
    TPESearcher,
    TuneConfig,
    Tuner,
)
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _cpu_tuner(trainable, **kw):
    return Tuner(trainable, device="cpu", **kw)


# ------------------------------------------------------ tests/test_tune.py


def test_variant_generation():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.choice([1, 2]),
        "fixed": 7,
    }
    variants = tune.BasicVariantGenerator(space, num_samples=3, seed=0).variants()
    assert len(variants) == 6  # 2 grid × 3 samples
    assert {v["lr"] for v in variants} == {0.1, 0.01}
    assert all(v["fixed"] == 7 for v in variants)
    assert all(v["wd"] in (1, 2) for v in variants)


def test_search_domains():
    rng = random.Random(0)
    assert 1 <= tune.uniform(1, 2).sample(rng) <= 2
    assert 1e-4 <= tune.loguniform(1e-4, 1e-1).sample(rng) <= 1e-1
    assert tune.randint(0, 5).sample(rng) in range(5)
    assert tune.choice(["a", "b"]).sample(rng) in ("a", "b")


def _objective(config):
    from ray_tpu_torch.train import session

    # quadratic bowl: best at x=3
    score = -((config["x"] - 3.0) ** 2)
    for i in range(5):
        session.report({"score": score + i * 0.01,
                        "device": str(session.get_device())})


def test_tuner_finds_best(cluster):
    tuner = _cpu_tuner(
        _objective,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=1,
                               max_concurrent_trials=2),
    )
    grid = tuner.fit(timeout=300)
    assert len(grid) == 4
    best = grid.get_best_result()
    assert best.metrics["config"]["x"] == 3.0
    assert best.metrics["score"] > -0.1
    # Every trial ran on the device the Tuner named.
    assert {r["device"] for t in grid.trials for r in t.reports} == {"cpu"}


def test_asha_early_stops(cluster):
    def slow_objective(config):
        import time

        from ray_tpu_torch.train import session

        for i in range(1, 13):
            session.report({"loss": config["badness"] * 1.0, "iter": i})
            time.sleep(0.03)

    scheduler = ASHAScheduler(
        metric="loss", mode="min", time_attr="training_iteration",
        max_t=12, grace_period=2, reduction_factor=2,
    )
    tuner = _cpu_tuner(
        slow_objective,
        param_space={"badness": tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        tune_config=TuneConfig(metric="loss", mode="min",
                               scheduler=scheduler, max_concurrent_trials=4),
    )
    grid = tuner.fit(timeout=300)
    best = grid.get_best_result()
    assert best.metrics["config"]["badness"] == 1.0
    # at least one bad trial stopped before finishing all 12 reports
    n_reports = [len(t.reports) for t in grid.trials]
    assert min(n_reports) < 12, n_reports


def test_trial_error_handling(cluster):
    def sometimes_fails(config):
        from ray_tpu_torch.train import session

        if config["x"] == 1:
            raise RuntimeError("bad trial")
        session.report({"score": config["x"]})

    tuner = _cpu_tuner(
        sometimes_fails,
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(metric="score", mode="max"),
    )
    grid = tuner.fit(timeout=300)
    assert len(grid.errors) == 1
    assert grid.get_best_result().metrics["config"]["x"] == 2


def test_pbt_exploits(cluster):
    def trainable(config):
        import time

        from ray_tpu_torch.train import session
        from ray_tpu_torch.train.checkpoint import Checkpoint

        # score grows at rate `rate`; PBT should propagate high-rate configs
        ck = session.get_checkpoint()
        score = ck["score"] if ck else 0.0
        for i in range(1, 11):
            score += config["rate"]
            session.report(
                {"score": score},
                checkpoint=Checkpoint.from_dict({"score": score}),
            )
            time.sleep(0.05)

    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"rate": [1.0, 5.0]}, seed=0,
        quantile_fraction=0.34,
    )
    tuner = _cpu_tuner(
        trainable,
        param_space={"rate": tune.grid_search([0.1, 0.1, 5.0])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=pbt,
                               max_concurrent_trials=3),
    )
    grid = tuner.fit(timeout=300)
    best = grid.get_best_result()
    # the winning lineage must have adopted the high rate
    assert best.metrics["score"] > 10


# ----------------------------------------------- tests/test_tune_widen.py


class _T:
    def __init__(self, trial_id, config=None):
        self.trial_id = trial_id
        self.config = config or {}
        self.exploit_request = None


class TestSchedulersUnit:
    def test_median_stopping_cuts_below_median(self):
        rule = MedianStoppingRule(metric="acc", grace_period=1,
                                  min_samples_required=3)
        # Three healthy trials at step 1.
        for tid, acc in [("a", 0.9), ("b", 0.8), ("c", 0.7)]:
            assert rule.on_result(
                _T(tid), {"acc": acc, "training_iteration": 1}) == CONTINUE
        # A clearly-bad fourth trial is stopped.
        assert rule.on_result(
            _T("bad"), {"acc": 0.1, "training_iteration": 1}) == STOP
        # A top trial continues.
        assert rule.on_result(
            _T("d"), {"acc": 0.95, "training_iteration": 1}) == CONTINUE

    def test_hyperband_rungs_cut_bottom(self):
        hb = HyperBandScheduler(metric="acc", max_t=9, eta=3)
        assert hb.rungs == [1, 3, 9]
        # At rung t=1: scores 0.9, 0.5, 0.1 → keep top 1/3 as they arrive.
        assert hb.on_result(_T("a"), {"acc": 0.9,
                                      "training_iteration": 1}) == CONTINUE
        hb.on_result(_T("b"), {"acc": 0.5, "training_iteration": 1})
        out_c = hb.on_result(_T("c"), {"acc": 0.1, "training_iteration": 1})
        assert out_c == STOP
        assert hb.on_result(_T("a"), {"acc": 0.9,
                                      "training_iteration": 9}) == STOP


class TestSearcherUnit:
    def test_random_searcher_within_domain(self):
        s = RandomSearcher({"lr": tune.loguniform(1e-4, 1e-1),
                            "n": tune.randint(1, 5), "fixed": 3}, seed=0)
        for i in range(10):
            cfg = s.suggest(f"t{i}")
            assert 1e-4 <= cfg["lr"] <= 1e-1
            assert 1 <= cfg["n"] < 5
            assert cfg["fixed"] == 3

    def test_tpe_concentrates_near_optimum(self):
        """Optimizing -(x-0.7)^2: after warmup, TPE suggestions should
        cluster near 0.7 far more than uniform sampling would."""
        space = {"x": tune.uniform(0.0, 1.0)}
        s = TPESearcher(space, metric="score", seed=1, n_initial=8)
        for i in range(40):
            cfg = s.suggest(f"t{i}")
            score = -(cfg["x"] - 0.7) ** 2
            s.observe(cfg, score)
        late = [s.suggest(f"probe{i}")["x"] for i in range(30)]
        near = sum(1 for x in late if abs(x - 0.7) < 0.2)
        assert near >= 20, (near, sorted(late))


def _trainable(config):
    from ray_tpu_torch.train import session

    for i in range(3):
        session.report({"score": config["x"] * (i + 1)},
                       checkpoint={"step": i})


class TestTunerIntegration:
    def test_search_alg_drives_configs(self, cluster):
        searcher = TPESearcher({"x": tune.uniform(0, 1)}, metric="score",
                               seed=0, n_initial=2)
        tuner = _cpu_tuner(
            _trainable,
            tune_config=TuneConfig(metric="score", mode="max", num_samples=4,
                                   max_concurrent_trials=2,
                                   search_alg=searcher),
        )
        grid = tuner.fit(timeout=300)
        assert len(grid) == 4
        assert len(searcher._observed) == 4
        best = grid.get_best_result()
        assert best.metrics["score"] > 0

    def test_experiment_checkpoint_and_resume(self, cluster, tmp_path):
        run_cfg = RunConfig(name="exp1", storage_path=str(tmp_path))
        tuner = _cpu_tuner(
            _trainable,
            param_space={"x": tune.grid_search([0.1, 0.2, 0.3])},
            tune_config=TuneConfig(metric="score", mode="max"),
            run_config=run_cfg,
        )
        grid = tuner.fit(timeout=300)
        assert len(grid) == 3
        exp_dir = os.path.join(str(tmp_path), "exp1")
        assert os.path.exists(os.path.join(exp_dir, "tuner.pkl"))

        # Restore: all trials TERMINATED → nothing re-runs, results intact.
        restored = Tuner.restore(exp_dir, _trainable, device="cpu")
        grid2 = restored.fit(timeout=60)
        assert len(grid2) == 3
        assert grid2.get_best_result(
            metric="score").metrics["score"] == pytest.approx(0.9)

    def test_resume_reruns_unfinished_trials(self, cluster, tmp_path):
        import pickle

        exp_dir = str(tmp_path / "exp2")
        os.makedirs(exp_dir)
        # Simulated crash mid-experiment: one trial done, one mid-flight.
        state = {
            "param_space": {},
            "trials": [
                {"trial_id": "done", "config": {"x": 0.5}, "state":
                 "TERMINATED",
                 "reports": [{"score": 1.5, "training_iteration": 3}],
                 "last_checkpoint": None, "error": None, "failures": 0,
                 "iteration": 3},
                {"trial_id": "mid", "config": {"x": 0.9}, "state": "RUNNING",
                 "reports": [{"score": 0.9, "training_iteration": 1}],
                 "last_checkpoint": {"step": 0}, "error": None,
                 "failures": 0, "iteration": 1},
            ],
        }
        with open(os.path.join(exp_dir, "tuner.pkl"), "wb") as f:
            pickle.dump(state, f)
        restored = Tuner.restore(
            exp_dir, _trainable, device="cpu",
            tune_config=TuneConfig(metric="score", mode="max"))
        grid = restored.fit(timeout=300)
        by_id = {t.trial_id: t for t in grid.trials}
        assert by_id["done"].state == "TERMINATED"
        assert len(by_id["done"].reports) == 1  # untouched
        assert by_id["mid"].state == "TERMINATED"
        assert by_id["mid"].reports[-1]["score"] == pytest.approx(2.7)


class TestBayesOptAndSync:
    def test_bayesopt_concentrates_near_optimum(self):
        """Native GP+EI searcher beats random on a smooth objective within
        a small budget."""
        from ray_tpu_torch.tune.search import BayesOptSearcher

        space = {"x": tune.uniform(0, 1), "lr": tune.loguniform(1e-5, 1e-1)}
        s = BayesOptSearcher(space, metric="score", seed=0, n_initial=6)
        best = -1e9
        for i in range(30):
            cfg = s.suggest(f"t{i}")
            val = -(cfg["x"] - 0.3) ** 2 \
                - 0.1 * (math.log10(cfg["lr"]) + 3) ** 2
            s.observe(cfg, val)
            best = max(best, val)
        assert best > -0.02, best

    def test_bayesopt_drives_tuner(self, cluster):
        from ray_tpu_torch.tune.search import BayesOptSearcher

        searcher = BayesOptSearcher({"x": tune.uniform(0, 1)},
                                    metric="score", seed=0, n_initial=2)
        tuner = _cpu_tuner(
            _trainable,
            tune_config=TuneConfig(metric="score", mode="max",
                                   num_samples=4, max_concurrent_trials=2,
                                   search_alg=searcher),
        )
        grid = tuner.fit(timeout=300)
        assert len(grid) == 4 and len(searcher._observed) == 4

    def test_experiment_sync_and_uri_restore(self, cluster, tmp_path):
        """RunConfig.sync_config mirrors the experiment dir to a storage
        URI; Tuner.restore(uri) downloads and resumes from it."""
        from ray_tpu_torch.tune.syncer import SyncConfig

        upload = f"file://{tmp_path}/bucket"
        run_cfg = RunConfig(
            name="synced", storage_path=str(tmp_path / "local"),
            sync_config=SyncConfig(upload_dir=upload, sync_period_s=0.0))
        tuner = _cpu_tuner(
            _trainable,
            param_space={"x": tune.grid_search([0.1, 0.4])},
            tune_config=TuneConfig(metric="score", mode="max"),
            run_config=run_cfg,
        )
        grid = tuner.fit(timeout=300)
        assert len(grid) == 2
        synced_pkl = tmp_path / "bucket" / "synced" / "tuner.pkl"
        assert synced_pkl.exists(), "experiment state not synced to bucket"

        restored = Tuner.restore(f"{upload}/synced", _trainable, device="cpu")
        grid2 = restored.fit(timeout=60)
        assert grid2.get_best_result(
            metric="score").metrics["score"] == pytest.approx(1.2)


class TestPB2AndBOHB:
    def test_pb2_gp_exploit_picks_within_bounds(self):
        from ray_tpu_torch.tune import PB2

        sched = PB2(metric="score", perturbation_interval=1,
                    hyperparam_bounds={"lr": (1e-4, 1e-1)}, seed=0)
        trials = [_T(f"t{i}", {"lr": 10 ** (-1 - i)}) for i in range(4)]
        # Higher lr → higher score in this fake history.
        for it in range(1, 4):
            for i, t in enumerate(trials):
                sched.on_result(t, {"score": -i + it * 0.01,
                                    "training_iteration": it})
        worst = trials[-1]
        assert worst.exploit_request is not None
        new_lr = worst.exploit_request["config"]["lr"]
        assert 1e-4 <= new_lr <= 1e-1
        assert worst.exploit_request["from_trial"] is trials[0]

    def test_bohb_searcher_learns_from_rung_results(self):
        from ray_tpu_torch.tune import BOHBSearcher

        space = {"x": tune.uniform(0, 1)}
        s = BOHBSearcher(space, metric="score", seed=0, n_initial=3)
        # Intermediate rung results around x=0.8 score best.
        for i in range(12):
            x = i / 12
            s.on_trial_result(f"t{i}", {
                "score": -(x - 0.8) ** 2, "training_iteration": 2,
                "config": {"x": x}})
        draws = [s.suggest(f"n{i}")["x"] for i in range(30)]
        assert np.mean([abs(d - 0.8) < 0.25 for d in draws]) > 0.5
        # A later, larger-budget result supersedes the rung-2 one.
        s.on_trial_result("t0", {"score": 5.0, "training_iteration": 9,
                                 "config": {"x": 0.1}})
        assert any(b == 9 for (b, _c, _v) in s._rung_obs.values())

    def test_external_searcher_ask_tell_adapter(self, cluster):
        from ray_tpu_torch.tune import ExternalSearcher

        class OptunaLike:
            def __init__(self):
                self.told = []
                self.n = 0

            def ask(self):
                self.n += 1
                return {"x": 0.1 * self.n}

            def tell(self, params, value):
                self.told.append((params, value))

        ext = OptunaLike()
        tuner = _cpu_tuner(
            _trainable,
            tune_config=TuneConfig(metric="score", mode="max", num_samples=3,
                                   max_concurrent_trials=2,
                                   search_alg=ExternalSearcher(
                                       ext, metric="score")),
        )
        grid = tuner.fit(timeout=300)
        assert len(grid) == 3
        assert ext.n == 3
        assert len(ext.told) == 3
        xs = sorted(p["x"] for p, _v in ext.told)
        assert xs == pytest.approx([0.1, 0.2, 0.3])


# ------------------------------------------ parity with the JAX package


def _space(pkg):
    return {
        "lr": pkg.loguniform(1e-5, 1e-1),
        "x": pkg.uniform(-2.0, 3.0),
        "n": pkg.randint(1, 9),
        "act": pkg.choice(["relu", "gelu", "tanh"]),
        "wd": pkg.grid_search([0.0, 0.01, 0.1]),
        "fixed": 7,
    }


@pytest.mark.parametrize("seed,num_samples", [(0, 1), (3, 4), (17, 2)])
def test_variants_equal_the_reference(seed, num_samples):
    ours = tune.BasicVariantGenerator(_space(tune), num_samples,
                                      seed).variants()
    ref = jtune.BasicVariantGenerator(_space(jtune), num_samples,
                                      seed).variants()
    assert ours == ref and len(ours) == 3 * num_samples


def _report_sequence(seed, n_trials=6, n_steps=12):
    """One seeded interleaving of reports: (trial index, step, metric)."""
    rng = np.random.default_rng(seed)
    quality = rng.normal(size=n_trials)
    cursor = [0] * n_trials
    out = []
    while any(c < n_steps for c in cursor):
        i = int(rng.choice([j for j in range(n_trials)
                            if cursor[j] < n_steps]))
        cursor[i] += 1
        out.append((i, cursor[i],
                    float(quality[i] + 0.1 * cursor[i]
                          + 0.05 * rng.normal())))
    return out


def _decisions(make, seed, configs=None):
    """Feed one scheduler the seeded reports → each decision, with an
    exploit request's source trial and new config when one is made."""
    sched = make()
    trials = [_T(f"t{i}", dict((configs or {}).get(i, {"lr": 0.01 * (i + 1)})))
              for i in range(6)]
    out = []
    for i, step, metric in _report_sequence(seed):
        d = sched.on_result(trials[i], {"score": metric,
                                        "training_iteration": step})
        req = trials[i].exploit_request
        trials[i].exploit_request = None
        out.append((i, step, d, None if req is None else (
            req["from_trial"].trial_id, req["config"])))
    return out


_SCHEDULERS = {
    "asha": lambda m: m.ASHAScheduler(metric="score", mode="max", max_t=12,
                                      grace_period=1, reduction_factor=2),
    "asha_min": lambda m: m.ASHAScheduler(metric="score", mode="min",
                                          max_t=10, grace_period=2,
                                          reduction_factor=3),
    "hyperband": lambda m: m.HyperBandScheduler(metric="score", max_t=9,
                                                eta=3),
    "median": lambda m: m.MedianStoppingRule(metric="score", grace_period=2,
                                             min_samples_required=2),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="score", perturbation_interval=3, seed=5,
        hyperparam_mutations={"lr": [0.001, 0.01, 0.1], "mom": None},
        quantile_fraction=0.34),
    "pb2": lambda m: m.PB2(metric="score", perturbation_interval=2,
                           hyperparam_bounds={"lr": (1e-4, 1e-1)}, seed=7),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_equal_the_reference(name, seed):
    make = _SCHEDULERS[name]
    ours = _decisions(lambda: make(tsched), seed)
    ref = _decisions(lambda: make(jsched), seed)
    assert ours == ref
    if name.startswith(("asha", "hyperband", "median")):
        assert any(d == STOP for _i, _s, d, _r in ours), name
    if name in ("pbt", "pb2"):
        assert any(r is not None for *_x, r in ours), name


def _history(seed, n=14):
    rng = random.Random(seed)
    return [({"x": rng.uniform(0, 1), "lr": math.exp(rng.uniform(
        math.log(1e-5), math.log(1e-1))), "act": rng.choice(["a", "b", "c"])},
        rng.gauss(0, 1)) for _ in range(n)]


def _searcher_space(pkg):
    return {"x": pkg.uniform(0, 1), "lr": pkg.loguniform(1e-5, 1e-1),
            "act": pkg.choice(["a", "b", "c"]), "k": 3}


@pytest.mark.parametrize("kind", ["random", "tpe", "bayesopt", "bohb"])
@pytest.mark.parametrize("seed", [0, 11])
def test_searcher_suggestions_equal_the_reference(kind, seed):
    def run(pkg, search_mod):
        space = _searcher_space(pkg)
        if kind == "random":
            s = search_mod.RandomSearcher(space, seed=seed)
        elif kind == "tpe":
            s = search_mod.TPESearcher(space, "score", mode="min", seed=seed,
                                       n_initial=4)
        elif kind == "bayesopt":
            s = search_mod.BayesOptSearcher(space, "score", seed=seed,
                                            n_initial=4)
        else:
            s = search_mod.BOHBSearcher(space, "score", seed=seed,
                                        n_initial=4)
        out = []
        for j, (cfg, value) in enumerate(_history(seed)):
            out.append(s.suggest(f"t{j}"))
            if kind == "bohb":
                s.on_trial_result(f"t{j % 5}", {
                    "score": value, "training_iteration": 1 + j // 5,
                    "config": cfg})
            elif kind != "random":
                s.observe(cfg, value)
        out += [s.suggest(f"late{j}") for j in range(6)]
        return out

    from ray_tpu.tune import search as jsearch
    from ray_tpu_torch.tune import search as tsearch

    ours, ref = run(tune, tsearch), run(jtune, jsearch)
    assert ours == ref


def test_gp_posterior_equals_the_reference():
    from ray_tpu.tune.search import gp_posterior as jgp
    from ray_tpu_torch.tune.search import gp_posterior as tgp

    rng = np.random.default_rng(4)
    X, y, Xc = rng.random((9, 3)), rng.normal(size=9), rng.random((32, 3))
    for a, b in zip(tgp(X, y, Xc, 0.2, 1e-3), jgp(X, y, Xc, 0.2, 1e-3)):
        assert np.array_equal(a, b)


def test_syncer_names_the_ports_register_backend():
    from ray_tpu_torch.tune import syncer

    with pytest.raises(ValueError, match="ray_tpu_torch.tune.syncer"):
        syncer.get_backend("gs://bucket/exp")
    syncer.register_backend("mem", syncer._FileBackend)
    try:
        assert isinstance(syncer.get_backend("mem://x"), syncer._FileBackend)
    finally:
        syncer._BACKENDS.pop("mem")


# ----------------------------------------------- the port's own rules


def test_default_device_raises_at_fit_without_a_gpu(monkeypatch):
    """``Tuner(device=None)`` is cuda: without a GPU, ``fit`` raises
    before any trial starts (no cluster is needed to see it)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tuner = Tuner(_objective,
                  param_space={"x": tune.grid_search([0.0, 1.0])})
    assert tuner.device is None
    with pytest.raises(RuntimeError, match="no GPU"):
        tuner.fit(timeout=30)


def test_a_trial_that_cannot_take_its_device_fails():
    """A trial actor that cannot take the Tuner's device (here a device
    type the port does not run on) reports the reason as its error and
    is done, so ``fit`` records an ERROR trial instead of polling it
    forever; on a device it can take, ``session.get_device()`` names it."""
    import torch

    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.train.worker_group import TrainWorker

    w = TrainWorker(0, 1, None, 1)
    assert w.run_trial("meta", serialization.pack(_objective), {"x": 1.0}) \
        is False
    p = w.poll()
    assert p["done"] and "unsupported device meta" in p["error"]
    w = TrainWorker(0, 1, None, 1)
    assert w.run_trial("cpu", serialization.pack(_objective), {"x": 3.0})
    w.thread.join(60)
    p = w.poll()
    assert p["error"] is None and w.device == torch.device("cpu")
    assert [r["device"] for r in p["reports"]] == ["cpu"] * 5


def test_tensor_checkpoint_resumes(cluster, tmp_path):
    """A mid-flight trial's checkpoint holding a tensor goes through the
    port's serialization and restarts the trial from it."""
    import pickle

    import torch

    def resume(config):
        from ray_tpu_torch.train import session

        ck = session.get_checkpoint()
        w = ck["w"] if ck else torch.zeros(3)
        for _ in range(2):
            w = w + config["x"]
            session.report({"score": float(w.sum()),
                            "dtype": str(w.dtype)}, checkpoint={"w": w})

    exp_dir = str(tmp_path / "exp3")
    os.makedirs(exp_dir)
    with open(os.path.join(exp_dir, "tuner.pkl"), "wb") as f:
        pickle.dump({"param_space": {}, "trials": [{
            "trial_id": "mid", "config": {"x": 1.0}, "state": "RUNNING",
            "reports": [], "error": None, "failures": 0, "iteration": 0,
            "last_checkpoint": {"w": torch.full((3,), 5.0,
                                                dtype=torch.bfloat16)}}]},
            f)
    grid = Tuner.restore(exp_dir, resume, device="cpu",
                         tune_config=TuneConfig(metric="score")).fit(
                             timeout=120)
    (t,) = grid.trials
    assert t.state == "TERMINATED", t.error
    assert [r["score"] for r in t.reports] == [18.0, 21.0]
    assert t.reports[-1]["dtype"] == "torch.bfloat16"
    assert torch.equal(t.last_checkpoint["w"],
                       torch.full((3,), 7.0, dtype=torch.bfloat16))


def test_pickling_while_torch_imports_on_another_thread(monkeypatch):
    """A trial actor imports torch on its train thread while its poll()
    reply is pickled on another: the serializer must take a torch still
    initializing for an absent one (it read ``torch.Tensor`` off the
    half-made module and raised AttributeError)."""
    from ray_tpu_torch.core import serialization

    half = types.ModuleType("torch")
    half.__spec__ = types.SimpleNamespace(_initializing=True)
    monkeypatch.setitem(sys.modules, "torch", half)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        blob=serialization.pack({"reports": [{"loss": 1.0}], "done": False})))
    t.start()
    t.join(30)
    monkeypatch.undo()
    assert serialization.unpack(out["blob"]) == {
        "reports": [{"loss": 1.0}], "done": False}
