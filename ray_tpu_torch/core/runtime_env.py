"""Runtime environments: env vars, working_dir shipping, pip venv isolation.

Parity: `python/ray/_private/runtime_env/` — `env_vars`
(applied in the worker before user code runs), `working_dir` (directory
zipped by the submitter, content-addressed in the GCS KV as the reference
does with its package URIs (`runtime_env/packaging.py`), extracted +
sys.path'd on the executing node, cached by digest), and `pip`
(`runtime_env/pip.py`): the raylet builds a hashed, cached venv
(--system-site-packages, so jax & friends come from the base image) and
spawns the lease's worker with THAT interpreter. Entries may be package
specs or local wheel paths — wheels are content-addressed into the GCS KV
and installed with --no-index, which is also the zero-egress path this
fleet runs in. Venvs are LRU-evicted. Conda/container plugins are a
deliberate non-goal: TPU hosts run one prebuilt image.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile

from ray_tpu_torch.core.config import Config

MAX_WORKING_DIR_BYTES = 100 * 1024 * 1024
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def package_working_dir(path: str) -> tuple[str, bytes]:
    """Zip a directory → (content digest, zip bytes)."""
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for fn in sorted(files):
                full = os.path.join(root, fn)
                rel = os.path.relpath(full, path)
                total += os.path.getsize(full)
                if total > MAX_WORKING_DIR_BYTES:
                    raise ValueError(
                        f"working_dir {path} exceeds "
                        f"{MAX_WORKING_DIR_BYTES >> 20} MiB")
                zf.write(full, rel)
    data = buf.getvalue()
    return hashlib.sha256(data).hexdigest()[:32], data


def resolve_runtime_env(env: dict | None, client) -> dict | None:
    """Submitter side: upload working_dir / local wheels once
    (content-addressed KV), rewrite the env to reference URIs."""
    if not env:
        return env
    out = dict(env)
    wd = out.pop("working_dir", None)
    if wd:
        digest, data = package_working_dir(wd)
        key = f"pkg:{digest}".encode()
        if client.kv_get("runtime_env", key) is None:
            client.kv_put("runtime_env", key, data)
        out["working_dir_uri"] = digest
    pip = out.pop("pip", None)
    if pip:
        if isinstance(pip, str):
            pip = [pip]
        specs: list[str] = []
        wheels: dict[str, str] = {}     # basename → content digest
        for item in pip:
            if (item.endswith((".whl", ".tar.gz"))
                    and os.path.exists(item)):
                data = open(item, "rb").read()
                wdig = hashlib.sha256(data).hexdigest()[:32]
                key = f"whl:{wdig}".encode()
                if client.kv_get("runtime_env", key) is None:
                    client.kv_put("runtime_env", key, data)
                wheels[os.path.basename(item)] = wdig
            else:
                specs.append(item)
        env_digest = hashlib.sha256(repr(
            (sorted(specs), sorted(wheels.items()))
        ).encode()).hexdigest()[:32]
        out["pip_env"] = {"digest": env_digest, "specs": sorted(specs),
                          "wheels": wheels}
    return out


# ------------------------------------------------------------- pip venvs

PIP_CACHE_SIZE = int(os.environ.get("RAY_TPU_TORCH_PIP_ENV_CACHE", "8"))


def _pip_env_base(session_dir: str) -> str:
    """Root for built pip venvs. Defaults under the session dir; the
    `pip_env_cache_dir` knob relocates it to a machine-persistent path so
    identical envs are reused ACROSS cluster sessions (venv builds cost
    tens of seconds — content-addressed digests make cross-session reuse
    safe)."""
    from ray_tpu_torch.core.config import runtime_config

    override = runtime_config().pip_env_cache_dir
    return override or os.path.join(session_dir, "runtime_envs", "pip")


def pip_env_python(session_dir: str, digest: str) -> str:
    return os.path.join(_pip_env_base(session_dir), digest,
                        "venv", "bin", "python")


def ensure_pip_env(pip_env: dict, session_dir: str, kv_get) -> str:
    """Raylet side: build (or reuse) the venv for `pip_env`; returns its
    python executable. kv_get(ns, key) fetches uploaded wheels.

    Layout: <session>/runtime_envs/pip/<digest>/{venv/, wheels/, .ready,
    .last_used}. Build is atomic via the .ready marker; concurrent callers
    race benignly (same content). LRU beyond PIP_CACHE_SIZE evicts the
    least-recently-used ready env.
    """
    import shutil
    import subprocess
    import time

    base = _pip_env_base(session_dir)
    root = os.path.join(base, pip_env["digest"])
    ready = os.path.join(root, ".ready")
    py = pip_env_python(session_dir, pip_env["digest"])
    if os.path.exists(ready):
        _touch(os.path.join(root, ".last_used"))
        return py
    os.makedirs(root, exist_ok=True)
    venv_dir = os.path.join(root, "venv")
    wheel_dir = os.path.join(root, "wheels")
    os.makedirs(wheel_dir, exist_ok=True)
    for fname, wdig in pip_env.get("wheels", {}).items():
        data = kv_get("runtime_env", f"whl:{wdig}".encode())
        if data is None:
            raise RuntimeError(f"wheel {fname} ({wdig}) not in GCS KV")
        with open(os.path.join(wheel_dir, fname), "wb") as f:
            f.write(data)
    # --system-site-packages: the heavyweight base stack (jax, numpy, …)
    # comes from the image; the venv only layers the requested packages.
    subprocess.run(
        [sys.executable, "-m", "venv", "--system-site-packages", venv_dir],
        check=True, capture_output=True)
    # If the BASE interpreter is itself a venv (common in container images),
    # --system-site-packages links the system python's site dir, not the
    # base venv's. A .pth appends the parent's site-packages — after the
    # new venv's own, so requested packages still shadow the base.
    import glob as _glob

    parent_sites = [p for p in sys.path if p.endswith("site-packages")
                    and os.path.isdir(p)]
    for venv_site in _glob.glob(
            os.path.join(venv_dir, "lib", "python*", "site-packages")):
        with open(os.path.join(venv_site, "_parent_sites.pth"), "w") as f:
            f.write("\n".join(parent_sites) + "\n")
    targets = list(pip_env.get("specs", ()))
    wheel_files = [os.path.join(wheel_dir, f)
                   for f in sorted(pip_env.get("wheels", {}))]
    if wheel_files or targets:
        cmd = [py, "-m", "pip", "install", "--quiet",
               "--disable-pip-version-check"]
        if wheel_files and not targets:
            # Pure-local install: never touch an index (zero-egress path).
            cmd += ["--no-index"] + wheel_files
        else:
            cmd += ["--find-links", wheel_dir] + wheel_files + targets
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            shutil.rmtree(root, ignore_errors=True)
            raise RuntimeError(
                f"pip env build failed: {r.stderr[-800:]}")
    _touch(ready)
    _touch(os.path.join(root, ".last_used"))
    _evict_lru(base)
    return py


def _touch(path: str) -> None:
    with open(path, "a"):
        os.utime(path, None)


_EVICT_MIN_AGE_S = 3600.0


def _evict_lru(base: str) -> None:
    """Evict least-recently-used envs beyond the cache cap — but never one
    used within the last hour: a worker spawned on that interpreter may
    still be alive (the raylet's idle-worker TTL reaps it well within the
    age floor, so deleting only old envs can't pull the venv out from
    under a live process)."""
    import time

    try:
        envs = [
            (os.path.getmtime(os.path.join(base, d, ".last_used")), d)
            for d in os.listdir(base)
            if os.path.exists(os.path.join(base, d, ".ready"))
        ]
    except OSError:
        return
    if len(envs) <= PIP_CACHE_SIZE:
        return
    import shutil

    now = time.time()
    for mtime, d in sorted(envs)[: len(envs) - PIP_CACHE_SIZE]:
        if now - mtime < _EVICT_MIN_AGE_S:
            continue
        shutil.rmtree(os.path.join(base, d), ignore_errors=True)


_applied_dirs: dict[str, str] = {}


def apply_runtime_env(env: dict | None):
    """Worker side, before user code: set env vars; fetch/extract the
    working_dir by digest (cached per process) and make it cwd + sys.path
    head.

    Returns a restore() callable that undoes env vars / cwd / sys.path so a
    pooled worker doesn't leak one task's environment into the next (the
    reference instead dedicates workers per runtime env; restoring is the
    single-pool equivalent). Actors never restore — the env is theirs for
    life."""
    if not env:
        return lambda: None
    saved_env = {k: os.environ.get(k) for k in (env.get("env_vars") or {})}
    saved_cwd = os.getcwd()
    saved_path_entry: list[str] = []

    def restore():
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        try:
            os.chdir(saved_cwd)
        except OSError:
            pass
        for entry in saved_path_entry:
            try:
                sys.path.remove(entry)
            except ValueError:
                pass

    for k, v in (env.get("env_vars") or {}).items():
        os.environ[k] = str(v)
    digest = env.get("working_dir_uri")
    if not digest:
        return restore
    target = _applied_dirs.get(digest)
    if target is None:
        from ray_tpu_torch import api

        client = api._ensure_client()
        data = client.kv_get("runtime_env", f"pkg:{digest}".encode())
        if data is None:
            raise RuntimeError(f"working_dir package {digest} not in GCS")
        base = os.environ.get("RAY_TPU_TORCH_SESSION_DIR",
                              Config.session_dir)
        target = os.path.join(base, "runtime_envs", digest)
        if not os.path.isdir(target):
            tmp = f"{target}.{os.getpid()}.tmp"
            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, target)
            except OSError:  # another worker won the race
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        _applied_dirs[digest] = target
    os.chdir(target)
    if target not in sys.path:
        sys.path.insert(0, target)
        saved_path_entry.append(target)
    return restore
