"""The port's runtime, case for case as the JAX package's
``tests/test_runtime_env_pip.py``.

Pip runtime-env isolation.

runtime_env={"pip": [...]} → the raylet builds a hashed, cached venv
(--system-site-packages) and spawns the task's worker on that interpreter.
Zero-egress fleet: the tested path installs a locally-built wheel shipped
through the GCS KV (ref: python/ray/_private/runtime_env/
pip.py — hashed env, cached, worker runs inside it).
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

import ray_tpu_torch

# Machine-persistent pip runtime-env cache of the port's runtime (its own
# variable: the JAX runtime's is set by tests/conftest.py): the venv build
# costs ~60 s per fresh session dir; content-addressed digests make reuse
# safe.
os.environ.setdefault(
    "RAY_TPU_TORCH_PIP_ENV_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "ray_tpu_torch_pip_env_cache"))

PKG_NAME = "rtpu_testpkg"
PKG_VERSION = "1.2.3"


@pytest.fixture(scope="module")
def wheel_path(tmp_path_factory):
    """Build a tiny pure-python wheel locally (no index access)."""
    src = tmp_path_factory.mktemp("pkgsrc")
    pkg = src / PKG_NAME
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        f'__version__ = "{PKG_VERSION}"\n'
        "def shout():\n"
        f'    return "hello from {PKG_NAME}"\n')
    (src / "pyproject.toml").write_text(textwrap.dedent(f"""
        [build-system]
        requires = ["setuptools"]
        build-backend = "setuptools.build_meta"

        [project]
        name = "{PKG_NAME}"
        version = "{PKG_VERSION}"
        """))
    out = tmp_path_factory.mktemp("wheels")
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-index",
         "--no-build-isolation", "-w", str(out), str(src)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-800:]
    wheels = list(out.glob("*.whl"))
    assert len(wheels) == 1
    return str(wheels[0])


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_pip_env_visible_in_task_not_driver(cluster, wheel_path):
    # Driver does NOT have the package.
    with pytest.raises(ImportError):
        __import__(PKG_NAME)

    @ray_tpu_torch.remote
    def probe():
        import rtpu_testpkg

        return rtpu_testpkg.__version__, rtpu_testpkg.shout(), sys.executable

    version, msg, exe = ray_tpu_torch.get(
        probe.options(runtime_env={"pip": [wheel_path]}).remote(),
        timeout=300)
    assert version == PKG_VERSION
    assert msg == f"hello from {PKG_NAME}"
    # The worker ran on the venv interpreter, not the base one.
    assert "/venv/bin/python" in exe and exe != sys.executable

    # A task WITHOUT the env (base pool) cannot see the package.
    @ray_tpu_torch.remote
    def probe_base():
        try:
            __import__(PKG_NAME)
            return "visible"
        except ImportError:
            return "hidden"

    assert ray_tpu_torch.get(probe_base.remote(), timeout=120) == "hidden"


def test_pip_env_cached_across_tasks(cluster, wheel_path):
    """Second task with the SAME pip spec reuses the built venv (same
    interpreter path, warm worker) instead of rebuilding."""

    @ray_tpu_torch.remote
    def exe():
        return sys.executable

    env = {"pip": [wheel_path]}
    e1 = ray_tpu_torch.get(exe.options(runtime_env=env).remote(), timeout=300)
    e2 = ray_tpu_torch.get(exe.options(runtime_env=env).remote(), timeout=60)
    assert e1 == e2


def test_pip_env_actor(cluster, wheel_path):
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            import rtpu_testpkg

            self.v = rtpu_testpkg.__version__

        def version(self):
            return self.v

    h = Holder.options(runtime_env={"pip": [wheel_path]}).remote()
    assert ray_tpu_torch.get(h.version.remote(), timeout=300) == PKG_VERSION
    ray_tpu_torch.kill(h)
