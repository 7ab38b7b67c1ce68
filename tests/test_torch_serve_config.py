"""Declarative Serve ops surface of the port: YAML app config,
deploy/reconcile (ref: `python/ray/serve/schema.py:1`).

Mirrors ``tests/test_serve_config.py``'s `TestSchemaValidation`,
`TestDeployFromConfig` and `TestServeCLIAndREST` on the port's cluster,
exactly (no tolerance: the results are configs, names and integers),
the last through the port's CLI (``serve build``) and dashboard (the
``/api/serve/applications`` REST routes).
"""

import json
import sys
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.schema import (
    ServeConfig,
    app_statuses,
    delete_app,
    deploy_config,
)

APP_MODULE_SRC = '''
from ray_tpu_torch import serve


@serve.deployment(name="PreprocCfg")
class PreprocCfg:
    def __call__(self, x):
        return x["v"] * 2


@serve.deployment(name="EchoCfg")
class EchoCfg:
    def __init__(self, pre=None, tag="default"):
        self.pre = pre
        self.tag = tag

    def __call__(self, x):
        v = x["v"]
        if self.pre is not None:
            import ray_tpu_torch

            v = ray_tpu_torch.get(self.pre.remote(x), timeout=30)
        return {"tag": self.tag, "v": v}


app = EchoCfg.bind(PreprocCfg.bind(), tag="yaml")


def build_app(tag="built"):
    return EchoCfg.bind(PreprocCfg.bind(), tag=tag)


solo = EchoCfg.options(name="EchoCfg").bind(tag="solo")
'''


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    mod_dir = tmp_path_factory.mktemp("serve_cfg_mod")
    (mod_dir / "torch_serve_cfg_app_mod.py").write_text(APP_MODULE_SRC)
    sys.path.insert(0, str(mod_dir))
    ray_tpu_torch.init(num_cpus=4)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()
    sys.path.remove(str(mod_dir))


def _wait(fn, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.25)
    raise TimeoutError(msg)


class TestSchemaValidation:
    def test_rejects_malformed_configs(self):
        with pytest.raises(ValueError, match="applications"):
            ServeConfig.from_dict({"apps": []})
        with pytest.raises(ValueError, match="import_path"):
            ServeConfig.from_dict({"applications": [
                {"name": "a", "import_path": "no_colon_here"}]})
        with pytest.raises(ValueError, match="unknown deployment fields"):
            ServeConfig.from_dict({"applications": [
                {"name": "a", "import_path": "m:x",
                 "deployments": [{"name": "d", "replicas": 3}]}]})
        with pytest.raises(ValueError, match="duplicate"):
            ServeConfig.from_dict({"applications": [
                {"name": "a", "import_path": "m:x"},
                {"name": "a", "import_path": "m:y"}]})

    def test_deploy_rejects_cross_app_name_collision(self, cluster):
        cfg = ServeConfig.from_dict({"applications": [
            {"name": "a1", "import_path": "torch_serve_cfg_app_mod:solo"},
            {"name": "a2", "import_path": "torch_serve_cfg_app_mod:solo"}]})
        with pytest.raises(ValueError, match="declared by both"):
            deploy_config(cfg)

    def test_build_rejects_unknown_override_target(self, cluster):
        from ray_tpu_torch.serve.schema import AppConfig, build_app

        app = AppConfig.from_dict({
            "name": "a", "import_path": "torch_serve_cfg_app_mod:app",
            "deployments": [{"name": "NoSuchDep", "num_replicas": 2}]})
        with pytest.raises(ValueError, match="unknown deployments"):
            build_app(app)


class TestDeployFromConfig:
    def test_deploy_e2e_with_graph_and_overrides(self, cluster, tmp_path):
        import yaml

        cfg_path = tmp_path / "app.yaml"
        cfg_path.write_text(yaml.safe_dump({"applications": [{
            "name": "textapp",
            "import_path": "torch_serve_cfg_app_mod:app",
            "route_prefix": "/text",
            "deployments": [{"name": "EchoCfg", "num_replicas": 2}],
        }]}))
        out = deploy_config(ServeConfig.from_yaml_file(str(cfg_path)))
        assert sorted(out["textapp"]) == ["EchoCfg", "PreprocCfg"]
        # Override applied + graph child deployed and wired.
        assert serve.status()["EchoCfg"]["num_replicas"] == 2
        h = serve.get_deployment_handle("EchoCfg")
        res = ray_tpu_torch.get(h.remote({"v": 5}), timeout=60)
        assert res == {"tag": "yaml", "v": 10}
        # App status joins manifest and live state.
        st = app_statuses()
        assert set(st["applications"]["textapp"]["deployments"]) == {
            "EchoCfg", "PreprocCfg"}

    def test_in_place_update_and_reconcile(self, cluster):
        # Same app name, new declared state: builder target (different
        # tag), one replica, and NO PreprocCfg → the removed deployment
        # must be reconciled away, not left running.
        cfg = ServeConfig.from_dict({"applications": [{
            "name": "textapp",
            "import_path": "torch_serve_cfg_app_mod:solo",
            "deployments": [{"name": "EchoCfg", "num_replicas": 1}],
        }]})
        out = deploy_config(cfg)
        assert out["textapp"] == ["EchoCfg"]
        _wait(lambda: serve.status().get("PreprocCfg") is None,
              msg="stale deployment not reconciled away")
        _wait(lambda: serve.status()["EchoCfg"]["live_replicas"] == 1,
              msg="replica downscale")
        h = serve.get_deployment_handle("EchoCfg")
        res = ray_tpu_torch.get(h.remote({"v": 3}), timeout=60)
        assert res == {"tag": "solo", "v": 3}

    def test_builder_args_from_config(self, cluster):
        cfg = ServeConfig.from_dict({"applications": [{
            "name": "builtapp",
            "import_path": "torch_serve_cfg_app_mod:build_app",
            "args": {"tag": "from_args"},
        }]})
        deploy_config(cfg)
        # Full-declared-state semantics: the previous config's app
        # (textapp) is absent from this file → torn down; but EchoCfg is
        # re-declared here under builtapp, so it survives the handover.
        assert "textapp" not in app_statuses()["applications"]
        h = serve.get_deployment_handle("EchoCfg")
        res = ray_tpu_torch.get(h.remote({"v": 1}), timeout=60)
        assert res["tag"] == "from_args"
        delete_app("builtapp")
        _wait(lambda: serve.status().get("EchoCfg") is None,
              msg="delete_app")
        # Manifest is gone, not tombstoned: repeat delete fails loudly
        # and the app vanishes from status.
        with pytest.raises(KeyError):
            delete_app("builtapp")
        assert "builtapp" not in app_statuses()["applications"]


class TestServeCLIAndREST:
    def test_cli_build_emits_skeleton(self, cluster, tmp_path):
        from ray_tpu_torch.scripts.cli import main

        out_path = tmp_path / "skeleton.yaml"
        main(["serve", "build", "torch_serve_cfg_app_mod:app",
              "--name", "gen", "-o", str(out_path)])
        import yaml

        sk = yaml.safe_load(out_path.read_text())
        cfg = ServeConfig.from_dict(sk)     # round-trips through schema
        assert cfg.applications[0].name == "gen"
        assert {d.name for d in cfg.applications[0].deployments} == {
            "EchoCfg", "PreprocCfg"}

    def test_rest_deploy_status_delete(self, cluster):
        from ray_tpu_torch.dashboard import start_dashboard

        dash = start_dashboard(port=0)
        try:
            base = dash.url
            body = json.dumps({"applications": [{
                "name": "restapp",
                "import_path": "torch_serve_cfg_app_mod:solo",
            }]}).encode()
            req = urllib.request.Request(
                base + "/api/serve/applications", data=body, method="PUT",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert out["deployed"]["restapp"] == ["EchoCfg"]

            def live():
                with urllib.request.urlopen(
                        base + "/api/serve/applications", timeout=30) as r:
                    st = json.loads(r.read())
                d = st["applications"].get("restapp", {}).get(
                    "deployments", {}).get("EchoCfg", {})
                return d.get("live_replicas", 0) >= 1
            _wait(live, msg="REST-deployed app never became live")

            req = urllib.request.Request(
                base + "/api/serve/applications/restapp", method="DELETE")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read())["deleted"] == ["EchoCfg"]
            req = urllib.request.Request(
                base + "/api/serve/applications/nope", method="DELETE")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 404
        finally:
            dash.stop()
