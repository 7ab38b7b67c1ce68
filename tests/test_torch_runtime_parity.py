"""The port's runtime held to the JAX package's where both can run.

- ``serialization.pack`` of the same numpy values gives the same bytes in
  both runtimes;
- the ``Config`` dataclasses have the same fields with the same defaults,
  apart from the two documented differences (``llm_attn_impl`` "auto",
  the session directory);
- the id formats are equal (sizes, hex, the composed layouts);
- tensors on the object plane, pinned beside the JAX runtime's arrays: a
  top-level ``jax.Array`` comes back a numpy array, out-of-band, and a
  nested one comes back a ``jax.Array`` through jax's own pickling; a
  strided CPU tensor comes back a tensor, out-of-band, at top level and
  nested, owning a copy of its bytes (a CUDA tensor, which only the card
  has, is held in tests/test_torch_cuda.py);
- the two runtimes never attach to each other: each reads only its own
  environment prefix, a port driver started inside a JAX worker (whose
  environment names the live JAX cluster) starts its own cluster, and
  the reverse;
- the ops front ends keep to the port's names too: the CLI's head record
  lies in the port's own state directory, the job log directory under
  ``ray_tpu_torch`` in the temp directory, a job's environment names the
  port's cluster only as ``RAY_TPU_TORCH_ADDRESS``, and the port's
  ``stop`` never reads (nor signals the pid of) the JAX CLI's head file.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import config as jconfig
from ray_tpu.core import ids as jids
from ray_tpu.core import serialization as jser
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.core import ids as tids
from ray_tpu_torch.core import serialization as tser

DIFFERENT_DEFAULTS = {"llm_attn_impl": ("gather", "auto"),
                      "session_dir": ("/tmp/ray_tpu", os.path.join(
                          tempfile.gettempdir(), "ray_tpu_torch"))}


def _values():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i64_fortran": np.asfortranarray(
            rng.integers(0, 9, (4, 6)).astype(np.int64)),
        "nested": {"a": np.arange(7, dtype=np.int16), "b": [1, "x", None],
                   "c": (np.float64(2.5), b"raw")},
        "bytes": b"\x00\x01" * 100,
        "scalar": 42,
    }


@pytest.mark.parametrize("name", sorted(_values()))
def test_pack_gives_the_same_bytes(name):
    v = _values()[name]
    assert tser.pack(v) == jser.pack(v)
    out = tser.unpack(tser.pack(v))
    assert pickle.dumps(out) == pickle.dumps(jser.unpack(jser.pack(v)))


def test_config_fields_equal_apart_from_documented_differences():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    assert list(tf) == list(jf)
    differ = {k: (jf[k], tf[k]) for k in jf if jf[k] != tf[k]}
    assert differ == DIFFERENT_DEFAULTS
    # A _system_config valid for one runtime is valid for the other.
    over = {"llm_tp": 2, "jax_recompile_storm_threshold": 3}
    assert tconfig.Config().override(over).llm_tp == 2
    assert jconfig.Config().override(over).llm_tp == 2


def test_session_dir_follows_tmpdir(tmp_path):
    """The port's session directory (logs, snapshots, spill files) lies
    under the temp directory that TMPDIR names, never at a fixed path."""
    code = ("from ray_tpu_torch.core.config import Config; "
            "print(Config().session_dir)")
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == os.path.join(str(tmp_path), "ray_tpu_torch")


def test_config_reads_only_its_own_environment(monkeypatch):
    monkeypatch.setenv("RAY_TPU_LLM_TP", "5")
    monkeypatch.setenv("RAY_TPU_CONFIG_JSON",
                       jconfig.Config(llm_tp=7).to_json())
    assert tconfig.current_config().llm_tp == 1
    monkeypatch.setenv("RAY_TPU_TORCH_LLM_TP", "3")
    assert tconfig.current_config().llm_tp == 3
    assert jconfig.current_config().llm_tp == 7
    assert tconfig.CONFIG_ENV_JSON == "RAY_TPU_TORCH_CONFIG_JSON"


def test_id_formats_equal():
    for name in ("JobID", "NodeID", "WorkerID", "PlacementGroupID",
                 "ActorID", "TaskID", "ObjectID"):
        j, t = getattr(jids, name), getattr(tids, name)
        raw = bytes(range(j.SIZE))
        assert t.SIZE == j.SIZE and t(raw).hex() == j(raw).hex(), name
    job_j, job_t = jids.JobID.from_int(9), tids.JobID.from_int(9)
    assert job_t.binary() == job_j.binary()
    aj = jids.ActorID(job_j.binary() + b"u" * 8)
    at = tids.ActorID(job_t.binary() + b"u" * 8)
    tj, tt = jids.TaskID.for_actor_task(aj), tids.TaskID.for_actor_task(at)
    assert tt.binary()[:12] == tj.binary()[:12] == at.binary()
    tt = tids.TaskID(tj.binary())
    for i in (1, 3):
        assert (tids.ObjectID.for_return(tt, i).binary()
                == jids.ObjectID.for_return(tj, i).binary())
        assert (tids.ObjectID.from_put(tt, i).binary()
                == jids.ObjectID.from_put(tj, i).binary())


def _round_trip(ser, value):
    head, views = ser.serialize(value)
    return ser.unpack(ser.pack(value)), len(views)


def test_arrays_and_tensors_are_pinned_at_top_level_and_nested():
    x = jnp.arange(6, dtype=jnp.float32)
    out, n = _round_trip(jser, x)
    assert type(out) is np.ndarray and n == 1
    out, n = _round_trip(jser, {"x": x})
    assert isinstance(out["x"], type(x)) and n == 0
    t = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    assert tser._to_host(t) is t            # only a CUDA tensor moves
    out, n = _round_trip(tser, t)
    assert type(out) is torch.Tensor and n == 1
    assert out.dtype == torch.bfloat16 and torch.equal(out, t)
    out, n = _round_trip(tser, {"x": t, "y": [t[1:4]]})
    assert n == 2 and torch.equal(out["x"], t)
    assert torch.equal(out["y"][0], t[1:4])
    # Not strided or needing grad: torch's own pickling, in-band.
    g = torch.ones(3, requires_grad=True)
    out, n = _round_trip(tser, g)
    assert n == 0 and out.requires_grad and torch.equal(out, g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int8, torch.bool, torch.complex64])
def test_tensor_bytes_travel_out_of_band(dtype):
    t = (torch.arange(24).reshape(2, 3, 4) % 3).to(dtype)
    view = t.transpose(0, 2)                # non-contiguous
    head, views = tser.serialize(view)
    assert [len(v) for v in views] == [t.numel() * t.element_size()]
    out = tser.unpack(tser.pack(view))
    assert out.shape == view.shape and torch.equal(out, view)
    assert torch.equal(tser.unpack(tser.pack(t[0, 0, 0])), t[0, 0, 0])
    empty = tser.unpack(tser.pack(t[:0]))
    assert empty.shape == (0, 3, 4) and empty.dtype == dtype


def test_a_rebuilt_tensor_owns_a_copy():
    """The documented choice: the rebuilt tensor copies the buffer (torch
    cannot mark a tensor read-only), so writing to it never reaches the
    bytes it came from, and a read-only source raises no warning."""
    t = torch.arange(16, dtype=torch.float32)
    blob = tser.pack(t)                      # bytes: a read-only buffer
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a = tser.unpack(blob)
    a.add_(1)
    assert torch.equal(tser.unpack(blob), t)
    buf = bytearray(blob)                    # writable: still a copy
    b = tser.unpack(buf)
    b.zero_()
    assert torch.equal(tser.unpack(buf), t)


def test_large_tensor_put_is_out_of_band_on_the_cluster():
    ray_tpu_torch.init(num_cpus=1)
    try:
        big = torch.randn(1 << 22).to(torch.bfloat16)      # 8 MiB
        head, views = tser.serialize(big)
        assert len(head) < 64 * 1024 and len(views) == 1

        @ray_tpu_torch.remote
        def checksum(t):
            return int(t.view(torch.int16).sum()), t.dtype, tuple(t.shape)

        ref = ray_tpu_torch.put(big)
        want = int(big.view(torch.int16).sum())
        assert ray_tpu_torch.get(checksum.remote(ref), timeout=60) == (
            want, torch.bfloat16, tuple(big.shape))
        assert torch.equal(ray_tpu_torch.get(ref), big)
    finally:
        ray_tpu_torch.shutdown()


def test_a_port_driver_in_a_jax_worker_starts_its_own_cluster():
    ray_tpu.init(num_cpus=1)
    try:
        @ray_tpu.remote
        def port_inside():
            import os

            from ray_tpu_torch import api

            named = os.environ.get("RAY_TPU_GCS_ADDRESS")
            client = api._ensure_client()
            try:
                @ray_tpu_torch.remote
                def where():
                    return os.environ.get("RAY_TPU_TORCH_WORKER_ID")

                wid = ray_tpu_torch.get(where.remote(), timeout=60)
                return (named, api._node is not None,
                        list(client.gcs_address), wid)
            finally:
                ray_tpu_torch.shutdown()

        named, own, port_gcs, wid = ray_tpu.get(port_inside.remote(),
                                                timeout=120)
        jax_gcs = list(ray_tpu.api._client.gcs_address)
        assert named == f"{jax_gcs[0]}:{jax_gcs[1]}"
        assert own and port_gcs != jax_gcs and wid
    finally:
        ray_tpu.shutdown()


def test_a_jax_driver_in_a_port_worker_starts_its_own_cluster():
    ray_tpu_torch.init(num_cpus=1)
    try:
        @ray_tpu_torch.remote
        def jax_inside():
            import os

            from ray_tpu import api

            named = os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS")
            client = api._ensure_client()
            try:
                @ray_tpu.remote
                def where():
                    return os.environ.get("RAY_TPU_WORKER_ID")

                wid = ray_tpu.get(where.remote(), timeout=60)
                return (named, api._node is not None,
                        list(client.gcs_address), wid)
            finally:
                ray_tpu.shutdown()

        named, own, jax_gcs, wid = ray_tpu_torch.get(jax_inside.remote(),
                                                     timeout=120)
        port_gcs = list(ray_tpu_torch.api._client.gcs_address)
        assert named == f"{port_gcs[0]}:{port_gcs[1]}"
        assert own and jax_gcs != port_gcs and wid
    finally:
        ray_tpu_torch.shutdown()


def test_cli_head_record_lies_in_the_ports_state_directory(monkeypatch,
                                                           tmp_path):
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch.scripts import cli as tcli

    monkeypatch.delenv("RAY_TPU_TORCH_STATE_DIR", raising=False)
    assert tcli.head_file() == os.path.expanduser(
        "~/.ray_tpu_torch/head.json")
    assert tcli.head_file() != jcli.HEAD_FILE
    monkeypatch.setenv("RAY_TPU_TORCH_STATE_DIR", str(tmp_path))
    assert tcli.head_file() == str(tmp_path / "head.json")
    # The JAX CLI's variable names nothing for the port.
    monkeypatch.setenv("RAY_TPU_STATE_DIR", "/nowhere")
    assert tcli.head_file() == str(tmp_path / "head.json")


def test_job_log_directory_follows_tmpdir(tmp_path):
    code = ("from ray_tpu_torch.job_submission import default_log_dir; "
            "print(default_log_dir())")
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == os.path.join(str(tmp_path), "ray_tpu_torch", "job_logs")


def test_job_environment_names_only_the_ports_cluster(monkeypatch):
    from ray_tpu import job_submission as jjobs
    from ray_tpu_torch import job_submission as tjobs

    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    monkeypatch.delenv("RAY_TPU_ADDRESS", raising=False)
    monkeypatch.setenv("RAY_TPU_GCS_ADDRESS", "10.0.0.1:1111")
    env = tjobs.job_env()
    assert "RAY_TPU_TORCH_ADDRESS" not in env      # a JAX worker's GCS
    assert "RAY_TPU_ADDRESS" not in env
    monkeypatch.setenv("RAY_TPU_TORCH_GCS_ADDRESS", "127.0.0.1:2222")
    env = tjobs.job_env({"EXTRA": "1"})
    assert env["RAY_TPU_TORCH_ADDRESS"] == "127.0.0.1:2222"
    assert env["EXTRA"] == "1" and "RAY_TPU_ADDRESS" not in env
    assert tjobs.JOB_MANAGER_NAME == jjobs.JOB_MANAGER_NAME   # per cluster


def test_job_in_a_port_cluster_attaches_to_it_not_a_jax_one():
    """A job submitted to the port's cluster, from a shell whose
    environment also names a (dead) JAX cluster, attaches to the port's:
    its driver sees the port's GCS and this cluster's CPUs."""
    from ray_tpu_torch import api
    from ray_tpu_torch.job_submission import JobSubmissionClient

    os.environ["RAY_TPU_ADDRESS"] = "127.0.0.1:9"
    try:
        ray_tpu_torch.init(num_cpus=3)
        gcs = api._ensure_client().gcs_address
        client = JobSubmissionClient()
        script = ("import os, ray_tpu_torch; ray_tpu_torch.init(); "
                  "print('AT', os.environ['RAY_TPU_TORCH_ADDRESS'], "
                  "float(ray_tpu_torch.cluster_resources()['CPU']))")
        job_id = client.submit_job(entrypoint=f'{sys.executable} -c "{script}"')
        assert client.wait_until_finished(job_id, timeout=120) == "SUCCEEDED"
        assert f"AT {gcs[0]}:{gcs[1]} 3.0" in client.get_job_logs(job_id)
    finally:
        os.environ.pop("RAY_TPU_ADDRESS", None)
        ray_tpu_torch.shutdown()


def test_port_stop_never_reads_the_jax_head_file(tmp_path):
    """A JAX head record under HOME names a live process of ours; the
    port's ``stop`` (no record of its own) must leave it alone."""
    home = tmp_path / "home"
    (home / ".ray_tpu").mkdir(parents=True)
    victim = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(120)"])
    try:
        (home / ".ray_tpu" / "head.json").write_text(
            '{"gcs_address": "127.0.0.1:1", "pid": %d}' % victim.pid)
        env = {k: v for k, v in os.environ.items()
               if k != "RAY_TPU_TORCH_STATE_DIR"}
        env["HOME"] = str(home)
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "stop"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "no local head recorded" in out.stderr
        assert victim.poll() is None
        assert not (home / ".ray_tpu_torch").exists()
    finally:
        victim.kill()
        victim.wait()
