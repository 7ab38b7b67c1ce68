"""Search spaces + suggestion generators.

Counterpart of ``ray_tpu/tune/search.py``, line for line: the same
seeded ``random.Random`` draws and numpy GP give the same variants and
suggestions from the same seed and history. Parity: `python/ray/tune/search/` — sample-space primitives
(`tune/search/sample.py`: uniform/loguniform/choice/randint/grid_search) and
the BasicVariantGenerator (random + grid expansion,
`search/basic_variant.py`).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class Randint(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    options: list

    def sample(self, rng):
        return rng.choice(self.options)


@dataclass
class GridSearch:
    values: list


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> Randint:
    return Randint(low, high)


def choice(options) -> Choice:
    return Choice(list(options))


def grid_search(values) -> GridSearch:
    return GridSearch(list(values))


class BasicVariantGenerator:
    """Grid axes fully expanded × num_samples random draws of the rest."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> list[dict]:
        grid_keys = [
            k for k, v in self.param_space.items()
            if isinstance(v, GridSearch)
        ]
        grids = [
            [(k, val) for val in self.param_space[k].values] for k in grid_keys
        ]
        out = []
        for combo in itertools.product(*grids) if grids else [()]:
            for _ in range(self.num_samples):
                cfg = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        continue
                    cfg[k] = v.sample(self.rng) if isinstance(v, Domain) else v
                cfg.update(dict(combo))
                out.append(cfg)
        return out


class Searcher:
    """Sequential suggestion seam (ref: tune/search/searcher.py): the
    Tuner asks for a config per new trial and reports observed results, so
    model-based searchers can adapt. Subclass and implement suggest()."""

    def __init__(self, param_space: dict, seed: int | None = None):
        self.param_space = param_space
        self.rng = random.Random(seed)

    def suggest(self, trial_id: str) -> dict:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        pass

    def _sample_space(self) -> dict:
        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, GridSearch):
                cfg[k] = self.rng.choice(v.values)
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self.rng)
            else:
                cfg[k] = v
        return cfg


class RandomSearcher(Searcher):
    def suggest(self, trial_id: str) -> dict:
        return self._sample_space()


class TPESearcher(Searcher):
    """Tree-structured-Parzen-style searcher (the role HyperOpt plays for
    the reference, without the dependency): after `n_initial` random
    trials, candidates are drawn near configs in the top `gamma` quantile
    and scored by a good/bad density ratio per dimension.

    Continuous domains use Gaussian kernels around good observations;
    choice/grid dims sample from the good histogram with smoothing.
    """

    def __init__(self, param_space: dict, metric: str, mode: str = "max",
                 seed: int | None = None, n_initial: int = 5,
                 gamma: float = 0.25, n_candidates: int = 24):
        super().__init__(param_space, seed)
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._observed: list[tuple[dict, float]] = []

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        if result and self.metric in result:
            self._observed.append(
                (dict(result["config"]) if "config" in result else {},
                 self.sign * result[self.metric]))

    def observe(self, config: dict, value: float) -> None:
        self._observed.append((config, self.sign * value))

    def _split(self):
        obs = sorted(self._observed, key=lambda o: -o[1])
        n_good = max(1, int(len(obs) * self.gamma))
        return obs[:n_good], obs[n_good:]

    def _kernel_sample(self, key: str, domain, good: list[dict]):
        vals = [g[key] for g, _ in [(g, v) for g, v in good] if key in g]
        if not vals:
            return domain.sample(self.rng) if isinstance(domain, Domain) else domain
        if isinstance(domain, (Uniform, LogUniform)):
            import math

            center = self.rng.choice(vals)
            if isinstance(domain, LogUniform):
                lo, hi = math.log(domain.low), math.log(domain.high)
                c = math.log(center)
                draw = self.rng.gauss(c, (hi - lo) * 0.15)
                return math.exp(min(max(draw, lo), hi))
            lo, hi = domain.low, domain.high
            draw = self.rng.gauss(center, (hi - lo) * 0.15)
            return min(max(draw, lo), hi)
        if isinstance(domain, Randint):
            center = self.rng.choice(vals)
            span = max(1, (domain.high - domain.low) // 6)
            draw = center + self.rng.randint(-span, span)
            return min(max(draw, domain.low), domain.high - 1)
        if isinstance(domain, (Choice, GridSearch)):
            options = (domain.options if isinstance(domain, Choice)
                       else domain.values)
            # good histogram with +1 smoothing
            weights = [1 + sum(1 for v in vals if v == o) for o in options]
            return self.rng.choices(options, weights=weights)[0]
        return domain

    def _score(self, cfg: dict, good: list, bad: list) -> float:
        """Sum of per-dim log(good density / bad density) via distance-based
        kernel estimates; higher = more like good trials."""
        import math

        def density(vals, x, span):
            if not vals:
                return 1e-9
            if isinstance(x, (int, float)) and span > 0:
                h = span * 0.2
                return sum(
                    math.exp(-((x - v) ** 2) / (2 * h * h)) for v in vals
                ) / len(vals) + 1e-9
            return (sum(1 for v in vals if v == x) + 0.5) / (len(vals) + 1)

        score = 0.0
        for k, domain in self.param_space.items():
            if not isinstance(domain, Domain) and not isinstance(
                    domain, GridSearch):
                continue
            gv = [g[k] for g, _ in good if k in g]
            bv = [b[k] for b, _ in bad if k in b]
            if isinstance(domain, (Uniform, LogUniform)):
                span = domain.high - domain.low
            elif isinstance(domain, Randint):
                span = domain.high - domain.low
            else:
                span = 0
            x = cfg[k]
            score += math.log(density(gv, x, span)) - math.log(
                density(bv, x, span))
        return score

    def suggest(self, trial_id: str) -> dict:
        if len(self._observed) < self.n_initial:
            return self._sample_space()
        good, bad = self._split()
        best_cfg, best_score = None, None
        for _ in range(self.n_candidates):
            cfg = {}
            for k, v in self.param_space.items():
                if isinstance(v, (Domain, GridSearch)):
                    cfg[k] = self._kernel_sample(k, v, good)
                else:
                    cfg[k] = v
            s = self._score(cfg, good, bad)
            if best_score is None or s > best_score:
                best_cfg, best_score = cfg, s
        return best_cfg


def gp_posterior(X, y, Xc, length_scale: float, noise: float):
    """RBF-kernel GP posterior mean/std at candidates Xc given (X, y).

    Cholesky-based (stable on near-singular K from duplicate configs);
    shared by BayesOptSearcher (EI) and PB2's UCB exploit step.
    """
    import numpy as np

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * length_scale ** 2))

    K = k(X, X) + noise * np.eye(len(X))
    Ks = k(X, Xc)
    Kss = np.ones(len(Xc))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    mu = Ks.T @ alpha
    v = np.linalg.solve(L, Ks)
    var = np.maximum(Kss - (v ** 2).sum(0), 1e-12)
    return mu, np.sqrt(var)


class BayesOptSearcher(Searcher):
    """Gaussian-process + expected-improvement searcher — the role BayesOpt
    /Ax/HEBO integrations play for the reference (`tune/search/bayesopt`),
    implemented natively on numpy (no external dependency, zero-egress
    image). Continuous/int domains are modeled in a normalized [0,1] GP
    (log-warped for LogUniform); choice/grid dims fall back to good-trial
    histogram sampling (mirroring TPESearcher) since a GP needs a metric
    space.
    """

    def __init__(self, param_space: dict, metric: str, mode: str = "max",
                 seed: int | None = None, n_initial: int = 5,
                 n_candidates: int = 128, length_scale: float = 0.2,
                 noise: float = 1e-3, xi: float = 0.01):
        super().__init__(param_space, seed)
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.n_initial = n_initial
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self._observed: list[tuple[dict, float]] = []
        self._cont_keys = [
            k for k, v in param_space.items()
            if isinstance(v, (Uniform, LogUniform, Randint))
        ]

    # -- observation plumbing (same contract as TPESearcher) --

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        if result and self.metric in result:
            self._observed.append(
                (dict(result["config"]) if "config" in result else {},
                 self.sign * result[self.metric]))

    def observe(self, config: dict, value: float) -> None:
        self._observed.append((config, self.sign * value))

    # -- GP machinery --

    def _encode(self, cfg: dict):
        import numpy as np

        x = []
        for k in self._cont_keys:
            d = self.param_space[k]
            v = cfg.get(k)
            if v is None:
                x.append(0.5)
            elif isinstance(d, LogUniform):
                lo, hi = math.log(d.low), math.log(d.high)
                x.append((math.log(v) - lo) / (hi - lo))
            else:
                x.append((v - d.low) / (d.high - d.low))
        return np.asarray(x, float)

    def _gp_posterior(self, X, y, Xc):
        return gp_posterior(X, y, Xc, self.length_scale, self.noise)

    def suggest(self, trial_id: str) -> dict:
        import numpy as np

        if len(self._observed) < self.n_initial or not self._cont_keys:
            return self._sample_space()
        X = np.stack([self._encode(c) for c, _ in self._observed])
        y = np.asarray([v for _, v in self._observed], float)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std

        cands = [self._sample_space() for _ in range(self.n_candidates)]
        Xc = np.stack([self._encode(c) for c in cands])
        try:
            mu, sigma = self._gp_posterior(X, yn, Xc)
        except np.linalg.LinAlgError:
            return self._sample_space()
        best = yn.max()
        # Expected improvement
        z = (mu - best - self.xi) / sigma
        phi = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        Phi = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = sigma * (z * Phi + phi)
        chosen = dict(cands[int(np.argmax(ei))])
        # Non-metric dims: bias toward the best half's histogram.
        cat_keys = [k for k, v in self.param_space.items()
                    if isinstance(v, (Choice, GridSearch))]
        if cat_keys and len(self._observed) >= 2:
            order = sorted(self._observed, key=lambda o: -o[1])
            good = order[: max(1, len(order) // 2)]
            for k in cat_keys:
                d = self.param_space[k]
                options = (d.options if isinstance(d, Choice) else d.values)
                vals = [g[k] for g, _ in good if k in g]
                weights = [1 + sum(1 for v in vals if v == o)
                           for o in options]
                chosen[k] = self.rng.choices(options, weights=weights)[0]
        return chosen


class BOHBSearcher(TPESearcher):
    """Model-based config suggestion for HyperBand brackets (ref:
    tune/search/bohb + schedulers/hb_bohb.py). Pair with
    HyperBandScheduler: the scheduler stops trials at rungs; this
    searcher additionally learns from INTERMEDIATE rung results (highest
    budget observed per trial), so later bracket configs come from the
    TPE model over partially-trained evidence — the BOHB coupling."""

    def __init__(self, param_space: dict, metric: str, mode: str = "max",
                 budget_attr: str = "training_iteration", **kw):
        super().__init__(param_space, metric, mode, **kw)
        self.budget_attr = budget_attr
        # trial_id → (budget, config, signed metric); only the largest
        # budget per trial feeds the model.
        self._rung_obs: dict[str, tuple] = {}

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        if not result or self.metric not in result:
            return
        b = result.get(self.budget_attr, 0)
        cur = self._rung_obs.get(trial_id)
        if cur is None or b >= cur[0]:
            self._rung_obs[trial_id] = (
                b, dict(result.get("config", {})),
                self.sign * result[self.metric])
        self._rebuild()

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        if result and self.metric in result:
            self.on_trial_result(trial_id, result)

    def _rebuild(self) -> None:
        self._observed = [
            (cfg, val) for (_b, cfg, val) in self._rung_obs.values()]


class ExternalSearcher(Searcher):
    """Adapter seam for third-party searchers (ref: the reference's
    tune/search/* integration wrappers). Wraps any object exposing an
    ask/tell-style interface; recognized method pairs, tried in order:

      suggest(trial_id) / on_trial_complete(trial_id, result)  (ray-like)
      ask() / tell(params, value)                              (optuna-like)

    The external object owns the search space; the Tuner only needs
    suggest() to return a plain config dict.
    """

    def __init__(self, external, metric: str | None = None,
                 mode: str = "max"):
        self.ext = external
        if (metric is None and not hasattr(external, "on_trial_complete")
                and hasattr(external, "tell")):
            # Without a metric we could never call tell(), silently
            # degrading an ask/tell optimizer to random search.
            raise ValueError(
                "ExternalSearcher(metric=...) is required for ask/tell-"
                f"style externals like {type(external).__name__}")
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self._asked: dict[str, Any] = {}

    def suggest(self, trial_id: str) -> dict:
        if hasattr(self.ext, "suggest"):
            return dict(self.ext.suggest(trial_id))
        if hasattr(self.ext, "ask"):
            params = self.ext.ask()
            self._asked[trial_id] = params
            return dict(params)
        raise TypeError(
            f"{type(self.ext).__name__} exposes neither suggest() nor ask()")

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        if hasattr(self.ext, "on_trial_complete"):
            self.ext.on_trial_complete(trial_id, result)
            return
        # Always retire the ask (errored/metric-less trials would
        # otherwise leak _asked entries and stay "running" in the
        # external's book-keeping).
        params = self._asked.pop(
            trial_id, (result or {}).get("config", {}))
        if hasattr(self.ext, "tell") and result and self.metric in result:
            self.ext.tell(params, self.sign * result[self.metric])
        elif hasattr(self.ext, "tell_failed"):
            self.ext.tell_failed(params)
