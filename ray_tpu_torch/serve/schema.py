"""Declarative Serve app config: YAML schema, build, deploy, reconcile.

The reference's production story is config-file driven: a YAML app spec
validated by `python/ray/serve/schema.py:1` and applied
with `serve deploy` (`serve/scripts.py:1`), where the controller
reconciles declared state against running state. This is the port's
equivalent: the same three verbs (deploy/status/delete) over the
asyncio controller, with per-application manifests persisted in the GCS
KV so a re-deploy can delete deployments that were REMOVED from the
file (declared-state semantics, not merge-only).

Config file shape:

    applications:
    - name: text_gen                 # unique app name
      import_path: my_pkg.my_mod:app # module:attr → Deployment, or a
                                     # builder fn returning one
      route_prefix: /gen             # optional ingress route override
      args: {model: opt_1_3b}        # builder kwargs (fn import_path)
      deployments:                   # per-deployment overrides by name
      - name: LLMDeployment
        num_replicas: 2
        max_concurrent_queries: 16
        autoscaling_config: {min_replicas: 1, max_replicas: 4}
        user_config: {...}
        ray_actor_options: {num_cpus: 1}

`import_path` must be importable by the process running the deploy (the
CLI adds cwd to sys.path, mirroring `serve run`'s module resolution).
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
from typing import Any

logger = logging.getLogger(__name__)

_OVERRIDE_FIELDS = (
    "num_replicas", "max_concurrent_queries", "user_config",
    "autoscaling_config", "ray_actor_options", "route_prefix",
    "pool_role",
)
_APPS_NS = "serve_apps"


@dataclasses.dataclass
class DeploymentOverride:
    name: str
    options: dict

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentOverride":
        if "name" not in d:
            raise ValueError(f"deployment override missing 'name': {d}")
        unknown = set(d) - {"name", *_OVERRIDE_FIELDS}
        if unknown:
            raise ValueError(
                f"unknown deployment fields {sorted(unknown)} for "
                f"{d['name']!r}; allowed: {sorted(_OVERRIDE_FIELDS)}")
        return cls(name=d["name"],
                   options={k: d[k] for k in _OVERRIDE_FIELDS if k in d})


@dataclasses.dataclass
class AppConfig:
    name: str
    import_path: str
    route_prefix: str | None = None
    args: dict = dataclasses.field(default_factory=dict)
    deployments: list[DeploymentOverride] = dataclasses.field(
        default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "AppConfig":
        for req in ("name", "import_path"):
            if req not in d:
                raise ValueError(f"application missing {req!r}: {d}")
        if ":" not in d["import_path"]:
            raise ValueError(
                f"import_path must be 'module:attr', got "
                f"{d['import_path']!r}")
        unknown = set(d) - {"name", "import_path", "route_prefix", "args",
                            "deployments"}
        if unknown:
            raise ValueError(
                f"unknown application fields {sorted(unknown)} for "
                f"{d['name']!r}")
        return cls(
            name=d["name"],
            import_path=d["import_path"],
            route_prefix=d.get("route_prefix"),
            args=d.get("args") or {},
            deployments=[DeploymentOverride.from_dict(x)
                         for x in d.get("deployments") or []],
        )


@dataclasses.dataclass
class ServeConfig:
    applications: list[AppConfig]

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        if not isinstance(d, dict) or "applications" not in d:
            raise ValueError("config must have a top-level 'applications'")
        apps = [AppConfig.from_dict(a) for a in d["applications"]]
        names = [a.name for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names: {names}")
        return cls(applications=apps)

    @classmethod
    def from_yaml_file(cls, path: str) -> "ServeConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def _import_target(import_path: str):
    mod_name, _, attr = import_path.partition(":")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise ValueError(
            f"{mod_name!r} has no attribute {attr!r}") from None


def _deployment_names(dep) -> list[str]:
    """The app's full deployment set: the ingress plus every Deployment
    bound (transitively) into init args — mirrors _resolve_graph's walk."""
    from ray_tpu_torch.serve.api import Deployment

    names = [dep.name]

    def walk(v):
        if isinstance(v, Deployment):
            names.extend(_deployment_names(v))
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    walk(dep.init_args)
    walk(dep.init_kwargs)
    return names


def _apply_overrides(dep, by_name: dict[str, dict]):
    """Return `dep` with config-file overrides applied to it and to every
    Deployment bound in its init-args graph (matched by name)."""
    from ray_tpu_torch.serve.api import Deployment

    def sub(v):
        if isinstance(v, Deployment):
            return _apply_overrides(v, by_name)
        if isinstance(v, (list, tuple)):
            return type(v)(sub(x) for x in v)
        if isinstance(v, dict):
            return {k: sub(x) for k, x in v.items()}
        return v

    dep = dep.options(
        init_args=tuple(sub(a) for a in dep.init_args),
        init_kwargs={k: sub(v) for k, v in dep.init_kwargs.items()},
    )
    if dep.name in by_name:
        dep = dep.options(**by_name[dep.name])
    return dep


def build_app(app: AppConfig):
    """import_path → a configured Deployment (overrides applied)."""
    from ray_tpu_torch.serve.api import Deployment

    target = _import_target(app.import_path)
    if callable(target) and not isinstance(target, Deployment):
        target = target(**app.args)
    if not isinstance(target, Deployment):
        raise ValueError(
            f"{app.import_path!r} resolved to {type(target).__name__}, "
            f"expected a serve Deployment (or a builder returning one)")
    by_name = {o.name: o.options for o in app.deployments}
    known = set(_deployment_names(target))
    missing = set(by_name) - known
    if missing:
        raise ValueError(
            f"app {app.name!r}: overrides for unknown deployments "
            f"{sorted(missing)}; app contains {sorted(known)}")
    dep = _apply_overrides(target, by_name)
    if app.route_prefix is not None:
        dep = dep.options(route_prefix=app.route_prefix)
    return dep


def _kv_client():
    from ray_tpu_torch import api as _api

    return _api._ensure_client()


def deploy_config(cfg: ServeConfig, *, blocking: bool = True,
                  timeout: float = 180.0) -> dict:
    """Apply a config: deploy every application, then reconcile — delete
    deployments that a previous deploy of the same app created but the
    new config no longer declares. Idempotent (controller redeploys
    in place on repeated deploys). → {app: [deployment names]}."""
    import json

    from ray_tpu_torch import serve

    # Build every app first: overrides validate up front, and the
    # config-wide declared set guards reconcile — a deployment one app
    # dropped but another app (or ordering) still declares must survive.
    built = [(app, build_app(app)) for app in cfg.applications]
    declared_by_app = {
        app.name: sorted(set(_deployment_names(dep)))
        for app, dep in built}
    seen: dict[str, str] = {}
    for app_name, names in declared_by_app.items():
        for n in names:
            if n in seen:
                raise ValueError(
                    f"deployment {n!r} declared by both {seen[n]!r} and "
                    f"{app_name!r}; deployment names are global")
            seen[n] = app_name
    all_declared = set(seen)

    result: dict[str, list[str]] = {}
    kv = _kv_client()
    for app, dep in built:
        declared = declared_by_app[app.name]
        prev_raw = kv.kv_get(_APPS_NS, app.name.encode())
        serve.run(dep, _blocking_until_ready=blocking, timeout=timeout)
        if prev_raw:
            for stale in sorted(
                    set(json.loads(prev_raw)) - all_declared):
                serve.delete(stale)
        kv.kv_put(_APPS_NS, app.name.encode(),
                  json.dumps(declared).encode())
        result[app.name] = declared
    # The config file is the FULL declared state (reference serve-deploy
    # v2 semantics): applications previously deployed from config but
    # absent from this file are torn down — except deployments the new
    # config re-declares under a different app, which it now owns.
    try:
        known = [k.decode() if isinstance(k, bytes) else k
                 for k in kv.kv_keys(_APPS_NS)]
    except Exception as e:
        # Stale apps can't be discovered → nothing is torn down this
        # apply. Declared state still deploys, but say why cleanup skipped.
        logger.warning("app manifest listing failed (skipping stale-app "
                       "teardown): %s", e)
        known = []
    for stale_app in sorted(set(known) - {a.name for a in cfg.applications}):
        raw = kv.kv_get(_APPS_NS, stale_app.encode())
        for dep_name in sorted(set(json.loads(raw) if raw else [])
                               - all_declared):
            try:
                serve.delete(dep_name)
            except Exception as e:
                # The undeclared deployment keeps running — that's config
                # drift, the one thing declarative apply exists to prevent.
                logger.warning("teardown of stale deployment %s failed: %s",
                               dep_name, e)
        kv.kv_del(_APPS_NS, stale_app.encode())
    return result


def app_statuses() -> dict:
    """Per-application status: the manifest joined with live controller
    state (the REST/CLI `status` payload)."""
    import json

    from ray_tpu_torch import serve

    try:
        deps = serve.status()
    except Exception:  # graftlint: disable=EXC-SWALLOW (no controller yet → empty state, not a crash)
        deps = {}
    kv = _kv_client()
    apps = {}
    try:
        names = kv.kv_keys(_APPS_NS)
    except Exception:  # graftlint: disable=EXC-SWALLOW (status query: unreachable KV reads as zero applications)
        names = []
    for key in names:
        name = key.decode() if isinstance(key, bytes) else key
        raw = kv.kv_get(_APPS_NS, name.encode())
        manifest = json.loads(raw) if raw else []
        apps[name] = {
            "deployments": {d: deps.get(d, {"status": "MISSING"})
                            for d in manifest},
        }
    return {"applications": apps, "deployments": deps}


def delete_app(name: str) -> list[str]:
    """Delete every deployment an application's manifest declares."""
    import json

    from ray_tpu_torch import serve

    kv = _kv_client()
    raw = kv.kv_get(_APPS_NS, name.encode())
    if raw is None:
        raise KeyError(f"unknown serve application {name!r}")
    manifest = json.loads(raw)
    for dep in manifest:
        try:
            serve.delete(dep)
        except Exception as e:
            logger.warning("delete of deployment %s (app %s) failed: %s",
                           dep, name, e)
    kv.kv_del(_APPS_NS, name.encode())
    return manifest


__all__ = [
    "AppConfig", "DeploymentOverride", "ServeConfig", "build_app",
    "deploy_config", "app_statuses", "delete_app",
]
