"""Package rules of the PyTorch port (ray_tpu_torch) and chip_smoke.py.

- no file of the port, nor chip_smoke.py, nor the card tests (which run
  where JAX is absent), imports jax or the ray_tpu package (found by
  scanning every import statement's AST);
- the default device is CUDA and raises without a GPU, and a CUDA
  request never falls back to a plain version;
- every kernel has its CUDA source, each naming the TPU kernel it
  replaces and what bounds it;
- the kernel builder imports without nvcc and raises a clear error only
  when asked to find it.
"""

import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests/test_torch_cuda.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nimport jax.numpy as jnp\n"
                 "from ray_tpu.models import gpt\n"
                 "from ray_tpu_torch.models import gpt as g\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == [
        "jax.numpy", "ray_tpu.models"]


def test_default_device_raises_without_cuda(monkeypatch):
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models import gpt, paged_kv
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.spmd import build_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        gpt.init_params(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        paged_kv.init_paged_kv(cfg, 4, 8)
    with pytest.raises(RuntimeError, match="no GPU"):
        LLMEngine(cfg, kv_mode="paged", n_slots=2, max_len=32, page_size=8,
                  prefill_chunk=8, prefill_token_budget=8)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_training(cfg, adamw(1e-3))
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_attention_on_a_cuda_request_never_runs_the_plain_path(
        monkeypatch):
    """A tensor that is not on the CPU goes to the kernels or raises: here
    the kernel path is forced for CPU tensors and nvcc is missing, so the
    call raises, launches nothing and never reaches a plain version."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as fa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    q = torch.zeros(1, 8, 2, 64)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)

    def plain(*a, **k):
        raise AssertionError("plain version reached on a CUDA request")

    monkeypatch.setattr(fa, "_on_cuda", lambda t: True)
    for name in ("reference_flash_fwd", "reference_flash_dq",
                 "reference_flash_dkv"):
        monkeypatch.setattr(fa, name, plain)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_stale", lambda: True)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    fa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_attention(q, q, q)
    lse = torch.zeros(1, 8, 2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_dq(q, q, q, q, lse, lse)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_dkv(q, q, q, q, lse, lse)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (0, 0, 0)


@pytest.mark.parametrize("name,replaces", [
    ("paged_decode.cu", "_decode_kernel"),
    ("paged_prefill.cu", "_prefill_kernel"),
    ("flash_fwd.cu", "_fwd_kernel"),
    ("flash_bwd.cu", "_dq_kernel"),
    ("flash_bwd.cu", "_dkv_kernel"),
])
def test_cuda_sources_exist_and_name_their_tpu_kernel(name, replaces):
    origin = ("ray_tpu/ops/attention.py" if name.startswith("flash")
              else "ray_tpu/ops/paged_attention.py")
    src = PORT / "ops" / "csrc" / name
    head = src.read_text()[:3000]
    assert origin in head and replaces in head
    assert "What bounds it" in head
    from ray_tpu_torch.ops import _build

    assert src in _build.sources()


def test_build_imports_without_nvcc(monkeypatch):
    from ray_tpu_torch.ops import _build

    assert _build.LIB_PATH.parts[-3:] == (
        "build", "ray_tpu_torch", "libkernels.so")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_dir_is_ignored_by_git():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "build/" in lines
