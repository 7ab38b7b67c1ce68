"""Trial schedulers: FIFO, ASHA, PBT, MedianStopping, HyperBand, PB2.

Counterpart of ``ray_tpu/tune/schedulers.py``, line for line: the same
report sequence and seed give the same decisions. Parity: `python/ray/tune/schedulers/` —
`async_hyperband.py` (ASHA: asynchronous successive halving with rungs at
r·ηᵏ, cutting below-median trials at each rung) and `pbt.py`
(population-based training: exploit top performers' config+checkpoint,
explore by mutation).
"""

from __future__ import annotations

import random
from typing import Any

CONTINUE, STOP = "CONTINUE", "STOP"


class FIFOScheduler:
    def on_result(self, trial, result: dict) -> str:  # noqa: ARG002
        return CONTINUE


class ASHAScheduler:
    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
    ):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.eta = reduction_factor
        # rung milestones: grace, grace*eta, grace*eta^2, ... < max_t
        self.rungs: list[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_records: dict[int, list[float]] = {r: [] for r in self.rungs}

    def _better(self, a: float, cutoff: float) -> bool:
        return a >= cutoff if self.mode == "max" else a <= cutoff

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        for rung in reversed(self.rungs):
            if t == rung:
                records = self.rung_records[rung]
                records.append(float(score))
                if len(records) < self.eta:
                    return CONTINUE  # not enough evidence yet
                k = max(1, len(records) // self.eta)
                top = sorted(records, reverse=(self.mode == "max"))[:k]
                cutoff = top[-1]
                return CONTINUE if self._better(float(score), cutoff) else STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT-lite: at every perturbation interval, bottom-quantile trials adopt
    a top-quantile trial's config (+checkpoint) with mutations."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: dict[str, Any] | None = None,
        quantile_fraction: float = 0.25,
        seed: int | None = None,
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.latest: dict[Any, dict] = {}     # trial → last result

    def on_result(self, trial, result: dict) -> str:
        self.latest[trial] = result
        t = result.get(self.time_attr, 0)
        if t and t % self.interval == 0:
            self._maybe_exploit(trial, result)
        return CONTINUE

    def _maybe_exploit(self, trial, result: dict) -> None:
        scored = [
            (r.get(self.metric), tr) for tr, r in self.latest.items()
            if r.get(self.metric) is not None
        ]
        if len(scored) < 2:
            return
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        n = len(scored)
        k = max(1, int(n * self.quantile))
        top = [tr for _, tr in scored[:k]]
        bottom = [tr for _, tr in scored[-k:]]
        if trial in bottom and trial not in top:
            src = self.rng.choice(top)
            trial.exploit_request = {
                "config": self._exploit_config(dict(src.config)),
                "from_trial": src,
            }

    def _exploit_config(self, base_cfg: dict) -> dict:
        """New config for an exploited trial (hook: PB2 overrides with a
        GP-bandit pick; PBT perturbs randomly)."""
        new_cfg = dict(base_cfg)
        for key, spec in self.mutations.items():
            if callable(spec):
                new_cfg[key] = spec()
            elif isinstance(spec, list):
                new_cfg[key] = self.rng.choice(spec)
            else:  # numeric factor perturbation
                factor = self.rng.choice([0.8, 1.2])
                new_cfg[key] = new_cfg.get(key, 1.0) * factor
        return new_cfg


class MedianStoppingRule:
    """Stop a trial whose running-average metric falls below the median of
    other trials' averages at the same step (ref: schedulers/
    median_stopping_rule.py)."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial_id → list of signed metric values per step
        self._history: dict[str, list[float]] = {}

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        if self.metric not in result:
            return CONTINUE
        h = self._history.setdefault(trial.trial_id, [])
        h.append(self.sign * result[self.metric])
        if t < self.grace_period:
            return CONTINUE
        step = len(h)
        means = [
            sum(other[:step]) / step
            for tid, other in self._history.items()
            if tid != trial.trial_id and len(other) >= step
        ]
        if len(means) < self.min_samples:
            return CONTINUE
        means.sort()
        median = means[len(means) // 2]
        my_mean = sum(h) / step
        return STOP if my_mean < median else CONTINUE


class HyperBandScheduler:
    """Synchronous-ish HyperBand bracket (ref: schedulers/hyperband.py),
    adapted to the event-driven on_result seam: trials are assigned to the
    bracket's rungs; at each rung boundary a trial stops unless it is in
    the top 1/eta of finishers at that rung so far."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, eta: int = 3):
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.time_attr = time_attr
        self.rungs: list[int] = []
        r = max_t
        while r >= 1:
            self.rungs.append(int(r))
            r //= eta
        self.rungs = sorted(set(self.rungs))  # ascending rung milestones
        self.eta = eta
        self.max_t = max_t
        self._rung_scores: dict[int, list[float]] = {r: [] for r in self.rungs}

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        if self.metric not in result:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        if t not in self._rung_scores:
            return CONTINUE
        score = self.sign * result[self.metric]
        scores = self._rung_scores[t]
        scores.append(score)
        k = max(1, len(scores) // self.eta)
        cutoff = sorted(scores, reverse=True)[k - 1]
        return CONTINUE if score >= cutoff else STOP


class PB2(PopulationBasedTraining):
    """Population-based bandits (ref: tune/schedulers/pb2.py): PBT where
    the exploit step picks the exploited trial's new continuous
    hyperparameters with a GP-UCB bandit fitted on (config → latest
    metric) observations, instead of random factor perturbation —
    markedly more sample-efficient at small population sizes (the PB2
    paper's claim, reproduced here with the native numpy GP).

    `hyperparam_bounds`: {key: (low, high)} continuous ranges to optimize;
    other mutation keys (lists/callables) keep PBT behavior.
    """

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: dict | None = None,
                 quantile_fraction: float = 0.25,
                 seed: int | None = None, ucb_kappa: float = 1.5):
        super().__init__(
            metric, mode, time_attr, perturbation_interval,
            hyperparam_mutations={}, quantile_fraction=quantile_fraction,
            seed=seed)
        self.bounds = dict(hyperparam_bounds or {})
        self.kappa = ucb_kappa
        from collections import deque

        # (config, signed metric); _gp_ucb_pick consumes the last ≤64
        # matching rows, so a bounded window is behavior-identical and
        # keeps long runs O(1) memory.
        self._history: deque = deque(maxlen=256)

    def on_result(self, trial, result: dict) -> str:
        if result.get(self.metric) is not None:
            sign = 1.0 if self.mode == "max" else -1.0
            self._history.append(
                (dict(trial.config), sign * result[self.metric]))
        return super().on_result(trial, result)

    def _gp_ucb_pick(self, base_cfg: dict) -> dict:
        """Candidate configs in bounds, scored by GP posterior mean +
        kappa * std over the normalized continuous dims."""
        import math

        import numpy as np

        keys = list(self.bounds)
        obs = [(c, v) for c, v in self._history
               if all(k in c for k in keys)][-64:]
        def norm(cfg):
            out = []
            for k in keys:
                lo, hi = self.bounds[k]
                x = min(max(cfg[k], lo), hi)
                if lo > 0 and hi / max(lo, 1e-12) > 100:   # log-scaled dim
                    out.append((math.log(x) - math.log(lo))
                               / (math.log(hi) - math.log(lo)))
                else:
                    out.append((x - lo) / (hi - lo))
            return out

        def denorm(z):
            cfg = {}
            for k, u in zip(keys, z):
                lo, hi = self.bounds[k]
                if lo > 0 and hi / max(lo, 1e-12) > 100:
                    cfg[k] = math.exp(
                        math.log(lo) + u * (math.log(hi) - math.log(lo)))
                else:
                    cfg[k] = lo + u * (hi - lo)
            return cfg

        rng = np.random.default_rng(self.rng.randrange(2**31))
        cand = rng.random((64, len(keys)))
        if len(obs) < 3:
            pick = cand[0]
        else:
            from .search import gp_posterior

            X = np.asarray([norm(c) for c, _ in obs])
            y = np.asarray([v for _, v in obs])
            y = (y - y.mean()) / max(y.std(), 1e-9)
            try:
                mu, sd = gp_posterior(X, y, cand,
                                      length_scale=0.25, noise=1e-2)
                pick = cand[int(np.argmax(mu + self.kappa * sd))]
            except np.linalg.LinAlgError:
                pick = cand[0]
        new = dict(base_cfg)
        new.update(denorm(pick))
        return new

    def _exploit_config(self, base_cfg: dict) -> dict:
        return self._gp_ucb_pick(base_cfg)
