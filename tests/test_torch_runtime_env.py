"""The port's runtime, case for case as the JAX package's
``tests/test_runtime_env.py``.

Runtime environments: env_vars + working_dir shipping."""

import os
import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


class TestEnvVars:
    def test_task_sees_env_vars(self, cluster):
        @ray_tpu_torch.remote
        def read_env():
            import os

            return os.environ.get("MY_FLAG")

        out = ray_tpu_torch.get(read_env.options(
            runtime_env={"env_vars": {"MY_FLAG": "on"}}).remote(), timeout=60)
        assert out == "on"

    def test_env_does_not_leak_to_next_task(self, cluster):
        """Pooled workers must restore env/cwd/sys.path between tasks."""
        @ray_tpu_torch.remote
        def read_env():
            import os

            return os.environ.get("LEAKY")

        out = ray_tpu_torch.get(read_env.options(
            runtime_env={"env_vars": {"LEAKY": "yes"}}).remote(), timeout=60)
        assert out == "yes"
        # Subsequent plain tasks (likely the same pooled worker) are clean.
        outs = ray_tpu_torch.get([read_env.remote() for _ in range(4)], timeout=60)
        assert outs == [None] * 4

    def test_actor_sees_env_vars(self, cluster):
        @ray_tpu_torch.remote
        class E:
            def read(self):
                import os

                return os.environ.get("ACTOR_FLAG")

        a = E.options(
            runtime_env={"env_vars": {"ACTOR_FLAG": "42"}}).remote()
        assert ray_tpu_torch.get(a.read.remote(), timeout=60) == "42"
        ray_tpu_torch.kill(a)


class TestWorkingDir:
    def test_working_dir_shipped_and_importable(self, cluster, tmp_path):
        pkg = tmp_path / "proj"
        pkg.mkdir()
        (pkg / "mymod.py").write_text("MAGIC = 'shipped-code'\n")
        (pkg / "data.txt").write_text("payload\n")

        @ray_tpu_torch.remote
        def use_module():
            import mymod  # only importable via the shipped working_dir

            return mymod.MAGIC, open("data.txt").read().strip()

        out = ray_tpu_torch.get(use_module.options(
            runtime_env={"working_dir": str(pkg)}).remote(), timeout=60)
        assert out == ("shipped-code", "payload")

    def test_package_cached_by_digest(self, cluster, tmp_path):
        from ray_tpu_torch import api
        from ray_tpu_torch.core.runtime_env import resolve_runtime_env

        pkg = tmp_path / "p2"
        pkg.mkdir()
        (pkg / "f.txt").write_text("x")
        client = api._ensure_client()
        env1 = resolve_runtime_env({"working_dir": str(pkg)}, client)
        env2 = resolve_runtime_env({"working_dir": str(pkg)}, client)
        assert env1["working_dir_uri"] == env2["working_dir_uri"]
        assert client.kv_get(
            "runtime_env", f"pkg:{env1['working_dir_uri']}".encode())

    def test_oversize_working_dir_rejected(self, cluster, tmp_path,
                                           monkeypatch):
        from ray_tpu_torch.core import runtime_env as re_mod

        monkeypatch.setattr(re_mod, "MAX_WORKING_DIR_BYTES", 10)
        pkg = tmp_path / "big"
        pkg.mkdir()
        (pkg / "blob.bin").write_bytes(b"z" * 100)
        with pytest.raises(ValueError, match="exceeds"):
            re_mod.package_working_dir(str(pkg))


class TestRestartComposition:
    def test_restarted_actor_keeps_runtime_env(self, cluster):
        """An actor restart replays the creation spec,
        so the fresh worker must re-apply the actor's runtime_env (env_vars)
        — not inherit whatever the pooled worker last ran."""
        import os as _os

        @ray_tpu_torch.remote(max_restarts=2, runtime_env={
            "env_vars": {"RESTART_ENV_PROBE": "sticky-value"}})
        class Probed:
            def read(self):
                import os

                return os.environ.get("RESTART_ENV_PROBE")

            def die(self):
                import os

                os._exit(1)

        a = Probed.remote()
        assert ray_tpu_torch.get(a.read.remote(), timeout=60) == "sticky-value"
        try:
            ray_tpu_torch.get(a.die.remote(), timeout=30)
        except Exception:
            pass
        # restarted actor (fresh worker) sees the same env
        deadline = time.time() + 60
        val = None
        while time.time() < deadline:
            try:
                val = ray_tpu_torch.get(a.read.remote(), timeout=30)
                break
            except Exception:
                time.sleep(0.5)
        assert val == "sticky-value"
