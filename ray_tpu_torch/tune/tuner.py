"""Tuner: hyperparameter search over trial actors.

Parity: `python/ray/tune/tuner.py:44,239` (Tuner.fit),
`tune/tune.py:131` (tune.run), `tune/execution/trial_runner.py:236`
(TrialRunner event loop: launch ≤ max_concurrent trials as actors, poll
results, apply scheduler decisions, retry failures). Trials run in
TrainWorker actors (function-trainable with session.report), so the same
session/report machinery serves Train and Tune.

Counterpart of ``ray_tpu/tune/tuner.py``. The reference's trial is
``TrainWorker(0, 1, None)`` then ``run_train_fn``: JAX finds its devices
by itself. Here a trial takes its device as ``TorchBackendConfig`` does:
``Tuner(device=None)`` is cuda and ``fit`` raises without a GPU;
``"cpu"`` is for tests. Each trial actor runs ``setup_torch(device)``
before its train function (``TrainWorker.run_trial``), so
``session.get_device()`` names it. ``resources_per_trial`` takes the
runtime's logical ``"GPU"`` resource (``{"CPU": 1, "GPU": 0.25}``: four
trials share a card; the runtime masks no GPUs, so every trial on a
one-card node trains on ``cuda:0``).
"""

from __future__ import annotations

import itertools
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization
from ray_tpu_torch.train.config import Result, RunConfig
from ray_tpu_torch.train.worker_group import TrainWorker
from ray_tpu_torch.tune.schedulers import CONTINUE, FIFOScheduler, STOP
from ray_tpu_torch.tune.search import BasicVariantGenerator

PENDING, RUNNING, TERMINATED, ERROR = (
    "PENDING", "RUNNING", "TERMINATED", "ERROR",
)


@dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    search_alg: Any = None           # Searcher: adaptive config suggestion
    seed: int | None = None
    time_attr: str = "training_iteration"


class Trial:
    def __init__(self, trial_id: str, config: dict):
        self.trial_id = trial_id
        self.config = config
        self.state = PENDING
        self.actor = None
        self.reports: list[dict] = []
        self.last_checkpoint = None
        self.error: str | None = None
        self.iteration = 0
        self.exploit_request: dict | None = None
        self.failures = 0

    def last_metrics(self) -> dict | None:
        return self.reports[-1] if self.reports else None

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.state})"


class ResultGrid:
    def __init__(self, trials: list[Trial], metric: str | None, mode: str):
        self.trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self.trials)

    def __iter__(self):
        for t in self.trials:
            yield self._to_result(t)

    def _to_result(self, t: Trial) -> Result:
        return Result(
            metrics={**(t.last_metrics() or {}), "config": t.config},
            checkpoint=t.last_checkpoint,
            error=RuntimeError(t.error) if t.error else None,
            metrics_history=t.reports,
        )

    def get_best_result(self, metric: str | None = None,
                        mode: str | None = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        assert metric, "metric required"
        best, best_v = None, None
        for t in self.trials:
            m = t.last_metrics()
            if not m or metric not in m:
                continue
            v = m[metric]
            if (
                best_v is None
                or (mode == "max" and v > best_v)
                or (mode == "min" and v < best_v)
            ):
                best, best_v = t, v
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return self._to_result(best)

    @property
    def errors(self) -> list[str]:
        return [t.error for t in self.trials if t.error]


class Tuner:
    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config: RunConfig | None = None,
        resources_per_trial: dict[str, float] | None = None,
        device: str | None = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources = resources_per_trial or {"CPU": 1}
        self.device = device      # None = cuda (raises without a GPU); "cpu"
        self._restored_trials: list[Trial] | None = None

    # ---- experiment-level checkpoint / resume ----
    # (ref: tune/execution/trial_runner.py:102 _ExperimentCheckpointManager)

    def _experiment_dir(self) -> str | None:
        if self.run_config.storage_path is None:
            return None
        import os

        d = os.path.join(self.run_config.storage_path,
                         self.run_config.name or "experiment")
        os.makedirs(d, exist_ok=True)
        return d

    def _save_experiment(self, trials: list[Trial]) -> None:
        d = self._experiment_dir()
        if d is None:
            return
        import os
        import pickle

        state = [{
            "trial_id": t.trial_id, "config": t.config, "state": t.state,
            "reports": t.reports, "last_checkpoint": t.last_checkpoint,
            "error": t.error, "failures": t.failures,
            "iteration": t.iteration,
        } for t in trials]
        tmp = os.path.join(d, f"tuner.pkl.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump({"trials": state, "param_space": self.param_space}, f)
        os.replace(tmp, os.path.join(d, "tuner.pkl"))

    @classmethod
    def restore(cls, path: str, trainable: Callable, **kwargs) -> "Tuner":
        """Resume an experiment from `storage_path/name` — or from a synced
        storage URI (e.g. "file://bucket/exp": downloaded to a local dir
        first; ref tune/syncer.py cloud restore). Finished trials keep
        their results; unfinished trials restart from their last
        checkpoint."""
        import os
        import pickle

        if "://" in path:
            import tempfile

            from ray_tpu_torch.tune.syncer import Syncer

            # Fresh dir per restore: a fixed shared path would merge stale
            # files from earlier restores of a same-named experiment (and
            # collide across users on shared machines).
            local = tempfile.mkdtemp(prefix="ray_tpu_torch_restored_")
            Syncer.download_experiment(path, local)
            path = local
        with open(os.path.join(path, "tuner.pkl"), "rb") as f:
            saved = pickle.load(f)
        storage_path, name = os.path.split(path.rstrip("/"))
        run_config = kwargs.pop("run_config", None) or RunConfig(
            name=name, storage_path=storage_path)
        tuner = cls(trainable, param_space=saved["param_space"],
                    run_config=run_config, **kwargs)
        trials = []
        for s in saved["trials"]:
            t = Trial(s["trial_id"], s["config"])
            t.reports = s["reports"]
            t.last_checkpoint = s["last_checkpoint"]
            t.error = s["error"]
            t.failures = s["failures"]
            t.iteration = s["iteration"]
            # In-flight trials resume from their last checkpoint.
            t.state = TERMINATED if s["state"] == TERMINATED else PENDING
            if s["state"] == ERROR:
                t.state = ERROR
            trials.append(t)
        tuner._restored_trials = trials
        return tuner

    def fit(self, poll_interval: float = 0.15,
            timeout: float | None = None) -> ResultGrid:
        from ray_tpu_torch._device import resolve_device

        resolve_device(self.device)   # no GPU for the default: raise here
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        searcher = tc.search_alg
        syncer = None
        if (self.run_config.sync_config is not None
                and self._experiment_dir() is not None):
            from ray_tpu_torch.tune.syncer import Syncer

            syncer = Syncer(self.run_config.sync_config,
                            self.run_config.name or "experiment")
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif searcher is not None:
            # Adaptive: configs are suggested at launch time (below).
            trials = []
        else:
            variants = BasicVariantGenerator(
                self.param_space, tc.num_samples, tc.seed
            ).variants()
            trials = [
                Trial(f"trial_{i:05d}_{uuid.uuid4().hex[:6]}", cfg)
                for i, cfg in enumerate(variants)
            ]
        fn_blob = serialization.pack(self.trainable)
        pending = [t for t in trials if t.state == PENDING]
        running: list[Trial] = []
        max_failures = self.run_config.failure_config.max_failures
        deadline = None if timeout is None else time.monotonic() + timeout

        actor_cls = rt.remote(TrainWorker).options(
            resources=self.resources, max_concurrency=4
        )

        def launch(trial: Trial, checkpoint=None):
            trial.actor = actor_cls.remote(0, 1, None,
                                           self.resources.get("CPU"))
            trial.actor.run_trial.remote(
                self.device, fn_blob, trial.config, checkpoint
            )
            trial.state = RUNNING

        def finish(trial: Trial) -> None:
            if searcher is not None:
                m = trial.last_metrics()
                searcher.on_trial_complete(
                    trial.trial_id,
                    None if m is None else {**m, "config": trial.config})

        n_created = len(trials)

        def next_pending() -> Trial | None:
            nonlocal n_created
            if pending:
                return pending.pop(0)
            if searcher is not None and n_created < tc.num_samples:
                tid = f"trial_{n_created:05d}_{uuid.uuid4().hex[:6]}"
                t = Trial(tid, searcher.suggest(tid))
                trials.append(t)
                n_created += 1
                return t
            return None

        while pending or running or (
                searcher is not None and n_created < tc.num_samples):
            if deadline is not None and time.monotonic() > deadline:
                for t in running:
                    self._stop_actor(t)
                    t.state = ERROR
                    t.error = "tune timeout"
                break
            while len(running) < tc.max_concurrent_trials:
                t = next_pending()
                if t is None:
                    break
                launch(t, t.last_checkpoint)
                running.append(t)
            time.sleep(poll_interval)
            dirty = False
            for t in list(running):
                try:
                    p = rt.get(t.actor.poll.remote(), timeout=60)
                except rt.RayTaskError as e:
                    t.failures += 1
                    if t.failures <= max_failures:
                        launch(t, t.last_checkpoint)
                    else:
                        t.state = ERROR
                        t.error = str(e)
                        running.remove(t)
                    continue
                decision = CONTINUE
                if p["reports"] or p.get("checkpoint") is not None or \
                        p["error"] or p["done"]:
                    dirty = True
                for r in p["reports"]:
                    t.iteration += 1
                    r.setdefault(tc.time_attr, t.iteration)
                    r["trial_id"] = t.trial_id
                    t.reports.append(r)
                    if searcher is not None and hasattr(
                            searcher, "on_trial_result"):
                        # Rung-aware searchers (BOHB) learn from
                        # intermediate results too.
                        searcher.on_trial_result(
                            t.trial_id, {**r, "config": t.config})
                    d = scheduler.on_result(t, r)
                    if d == STOP:
                        decision = STOP
                if p.get("checkpoint") is not None:
                    t.last_checkpoint = p["checkpoint"]
                if t.exploit_request is not None:
                    req = t.exploit_request
                    t.exploit_request = None
                    src: Trial = req["from_trial"]
                    self._stop_actor(t)
                    t.config = req["config"]
                    ck = src.last_checkpoint or self._fetch_checkpoint(src)
                    launch(t, ck)
                    continue
                if decision == STOP:
                    self._stop_actor(t)
                    t.state = TERMINATED
                    running.remove(t)
                    finish(t)
                elif p["error"]:
                    t.failures += 1
                    if t.failures <= max_failures:
                        self._stop_actor(t)
                        launch(t, t.last_checkpoint)
                    else:
                        t.state = ERROR
                        t.error = p["error"]
                        self._stop_actor(t)
                        running.remove(t)
                        finish(t)
                elif p["done"]:
                    ck = self._fetch_checkpoint(t)
                    if ck is not None:
                        t.last_checkpoint = ck
                    t.state = TERMINATED
                    self._stop_actor(t)
                    running.remove(t)
                    finish(t)
            if dirty:  # avoid rewriting unchanged state every poll tick
                self._save_experiment(trials)
                if syncer is not None:
                    try:
                        syncer.sync_up_if_due(self._experiment_dir())
                    except Exception:  # graftlint: disable=EXC-SWALLOW (sync is durability, not correctness)
                        pass
        self._save_experiment(trials)
        if syncer is not None:
            try:
                syncer.sync_up(self._experiment_dir())
            except Exception:  # graftlint: disable=EXC-SWALLOW (as above)
                pass
        return ResultGrid(trials, tc.metric, tc.mode)

    def _fetch_checkpoint(self, t: Trial):
        try:
            return rt.get(t.actor.get_checkpoint.remote(), timeout=30)
        except Exception:  # graftlint: disable=EXC-SWALLOW (a dead trial has no checkpoint)
            return None

    def _stop_actor(self, t: Trial) -> None:
        if t.actor is not None:
            try:
                rt.kill(t.actor)
            except Exception:  # graftlint: disable=EXC-SWALLOW (the actor may already be dead)
                pass
            t.actor = None
