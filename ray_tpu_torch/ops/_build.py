"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together), linked into
``build/ray_tpu_torch/libkernels.so`` at the repository root and loaded
with ``ctypes``. The sources expose plain C functions (no PyTorch
headers), so a build takes seconds. Nothing happens at import: the
first kernel launch builds, so ``python3 chip_smoke.py`` from a fresh
checkout builds everything it runs. A missing ``nvcc`` raises a clear
error at that first call, never at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "ray_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of nvcc (PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin)."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the ray_tpu_torch CUDA kernels are built "
        "from ray_tpu_torch/ops/csrc at first use and need the CUDA "
        "toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = sources() + sorted(CSRC.glob("*.cuh")) + [Path(__file__)]
    return any(p.stat().st_mtime > built for p in deps)


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel, then link libkernels.so.
    → the library path. Raises RuntimeError with nvcc's output on a
    failed compile."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"libkernels.so.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _s, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)
    if verbose:
        print("\n".join(logs), flush=True)
    return LIB_PATH


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _declare(lib: ctypes.CDLL) -> None:
    # int fn(dtype, q, k_pool, v_pool, tables, lengths, out, ws, counters,
    #        B, H, K, ps, n_pg, n_pages, n_split, sm_scale, stream)
    #        → cudaError_t (ws: the fp32 split workspace,
    #        n_split·B·H·(K+2) floats, counters: B·ceil(H/4) zero ints,
    #        both NULL for one split; n_pages: P+1)
    lib.rtt_paged_decode_attention.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
        _P]
    lib.rtt_paged_decode_attention.restype = _I
    # int fn(dtype, q, k_pool, v_pool, tables, offsets, lengths, out,
    #        B, C, H, K, ps, n_pg, sm_scale, maps, stream) → cudaError_t
    # (maps: the wgmma kernel's tensor maps, long long[3 x 17], or NULL)
    lib.rtt_paged_prefill_attention.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P]
    lib.rtt_paged_prefill_attention.restype = _I
    # The int8 programs: the same with (k_scale, v_scale), bf16 [P+1],
    # after v_pool.
    lib.rtt_paged_decode_attention_int8.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _F, _P]
    lib.rtt_paged_decode_attention_int8.restype = _I
    lib.rtt_paged_prefill_attention_int8.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
        _P, _P]
    lib.rtt_paged_prefill_attention_int8.restype = _I
    # size_t fn(dtype, quant, K, ps): shared memory of one prefill block
    lib.rtt_paged_prefill_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.rtt_paged_prefill_smem_bytes.restype = ctypes.c_size_t
    # int fn(dtype, q, k, v, o, lse, B, S, T, H, K, strides[12], causal,
    #        sm_scale, maps, stream) → cudaError_t (maps: bf16, the tensor
    #        maps of q, k, v, long long[3 x 17]; fp32 NULL)
    lib.rtt_flash_fwd.argtypes = [
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _P, _P]
    lib.rtt_flash_fwd.restype = _I
    # int fn(dtype, q, k, v, dO, lse, delta, dq, B, S, T, H, K,
    #        strides[15], causal, sm_scale, maps, stream) → cudaError_t
    #        (maps: bf16, the tensor maps of q, k, v, dO, long long[4 x 17];
    #        fp32 NULL)
    lib.rtt_flash_dq.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _P,
        _P]
    lib.rtt_flash_dq.restype = _I
    # int fn(dtype, q, k, v, dO, lse, delta, dk, dv, B, S, T, H, K,
    #        strides[18], causal, sm_scale, maps, stream) → cudaError_t
    #        (maps as for dq)
    lib.rtt_flash_dkv.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F,
        _P, _P]
    lib.rtt_flash_dkv.restype = _I
    lib.rtt_error_string.argtypes = [_I]
    lib.rtt_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().rtt_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")


__all__ = ["build", "library", "check", "find_nvcc", "LIB_PATH"]
