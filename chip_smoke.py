#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, as the chip check runs it
    python3 chip_smoke.py --only kernels --ptxas   # build + kernel checks
    python3 chip_smoke.py --only kernels,train     # the training slice
    python3 chip_smoke.py --only kernels,engine    # quantized serving

Phases, one JSON line each (the whole record also goes to
build/chip_smoke.json):

1. card: the ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: every CUDA kernel compiled from ray_tpu_torch/ops/csrc for
   sm_90a (one nvcc per source, all started together), with the build
   seconds, and per kernel whether its SASS (cuobjdump) holds HGMMA,
   UTMALDG, HMMA and UBLKCP: every instance of the bf16 flash forward, dq
   and dkv kernels and the paged prefill kernel (10 in all) must hold
   wgmma and TMA loads and no mma.sync, and every instance of the paged
   decode kernel (8) TMA loads.
3. kernels: each kernel against its plain PyTorch version on the card at
   OPT-1.3B attention shapes (H=32, K=64), page sizes {16, 64}, fp32 and
   bf16, and at head dim 128; the ragged cases (length 1, mid-page, page
   boundary, full table, idle all-null slot; prefill C=256 and C=40 at
   ragged offsets, full and width-sliced tables) and the engine's own
   shapes (decode: 16 slots on a 2048-position table, lengths up to 2048;
   prefill: 16-row dispatches of 256, most rows inert); the decode's
   split paths (one slot at 2048, the light-load view, lengths at the
   split edges, past the table and 0, ps 8), each decode call repeated
   for identical bits; the largest error
   printed beside its bound, long rows on their own; then each kernel,
   checked once more on the inputs it is timed on, timed (device time:
   `device_ms`, with CUDA events around calls as the host issues them
   beside it) at B=16, 1024-token contexts, page size 64, bf16, beside
   its bound, its plain version's time and F.scaled_dot_product_attention
   on the gathered timeline (a yardstick only: the port never calls it;
   for prefill with a bool mask and with causal_lower_right, the faster
   is ``library_ms``), the decode also at light load (2 of 16 slots live
   at 2048) and with the wrapper's host µs per call. Then bf16 prefill at
   page sizes 16, 32, 64, 128
   (the wgmma kernel) and 48 (the mma.sync kernel, by the shape rule),
   chunks of C = 40, 72 and 200 at ragged offsets, float and int8 pools.
   Then the int8 programs of both paged kernels the same way, on int8
   pools quantized by the port's _quant_write from rows whose pages have
   log-uniform amplitudes in [0.25, 4] (page sizes 16 and 64, head dims
   64 and 128, fp32 and bf16 q); on their timed inputs two planted
   faults in the plain version (scales indexed by table position, a
   page dropped) must fail the bf16 bound; with bf16 q each int8 case
   is also held to the plain version on q.float() (p unrounded, as in
   the Pallas programs), a bound the plain version on bf16 q (p rounded)
   must fail on the timed inputs; timed beside their bounds, plain
   versions and SDPA on the dequantized timeline.
   Then the three flash kernels (flash_fwd, flash_dq, flash_dkv), each
   against its plain version: fp32 and bf16, head dims 64 and 128,
   causal and non-causal, S=77/T=130, S=64/T=256, S=200/T=333, S=T=192,
   S=1/T=64 and S=130/T=1, in bf16 also on q, k, v as strided views of
   packed qkv tensors, the backward with an lse cotangent; then once more
   on the training step's own inputs ([8, 1024, 12, 64] bf16 causal),
   where a dropped 64-wide tile planted in the plain dq, dk and dv must
   fail the bound, then timed by device time beside each kernel's bound,
   its plain version and its library call: SDPA for the forward; for
   the backward the faster of aten's flash backward
   (`_scaled_dot_product_flash_attention_backward`) and the backward of
   SDPA's graph, each alone and held once to the plain versions, on the
   flash_dq row beside delta + dq + dkv (one call does all three);
   `flash_delta` alone; SDPA forward plus backward against the three
   kernels.
4. programs: prefill_chunk_paged and decode_step_paged at full opt_1_3b
   width (bf16, random weights from a seed), attn_impl "kernel" vs
   "gather" on copies of one pool; then the same with int8 weights
   (quantized from the same fp32 masters) on an int8 pool, held to a
   logit-MAE limit that a planted fault must exceed, with the int8
   weights' logits against the bf16 weights' as a fidelity reading.
5. profile: torch.profiler over one fused decode window and one prefill
   dispatch at the engine's shapes (device busy time, idle share, top
   ops); the decode window's device time with int8 against bf16 weights
   (float and int8 KV), and the window's K/V writes alone into each pool.
6. engine: LLMEngine(opt_1_3b, bf16) serving 16 seeded prompts of 128-1536
   tokens through start()/submit(), 32 greedy tokens each, with the
   kernel launch counters zeroed just before and read just after; then
   LLMEngine(opt_1_3b, weight_dtype="int8", kv_dtype="int8") from the
   fp32 masters on the same prompts: n_layers int8 launches per decode
   step and per prefill dispatch, no float paged launch, the
   kv_pool_bytes identity, weight bytes, and the share of each stream
   that agrees with the bf16 engine's.
7. train: build_training(gpt2_124m(max_seq=1024, remat=True,
   attn_impl="flash"), adamw(3e-4, weight_decay=0.1, mu_dtype=bf16))
   with seeded random weights and a seeded [8, 1024] batch: one step of
   "flash" against "xla" (plain attention) from the same parameters
   (the loss, the whole gradient and each layer's attention weights'
   gradients beside their tolerances; three planted faults in the flash
   backward must fail the same check), then a warm-up step and 12 timed
   steps with the flash launch counters zeroed just before and read just
   after (exactly 24 forward, 12 dq and 12 dkv launches per step: remat
   recomputes each block's forward), step time, tokens/s, MFU, the steps'
   peak memory and the losses; then torch.profiler over one step.
8. with --ab OLD_CHECKOUT: the flash forward, dq and dkv and the float
   and int8 paged prefill and decode (timed shape and light load, with
   the wrapper's host µs) against an older checkout's kernels, in turns.
9. the kernels line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failure raises: the script exits non-zero without the last line.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import gpt
from ray_tpu_torch.models import paged_kv as pk
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.spmd import build_training

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16
H, K = 32, 64                  # opt_1_3b attention shape
CAP = 2048                     # the engine phase's max_len: longest context
LONG_ROW = 1024                # attended positions from which a row is long
# fp32: reassociation of fp32 sums only.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: a bound from the rounding both sides do (unit roundoff u = 2^-8).
# Each rounds every probability to bf16 before the P.V product (relative
# error <= u each, the kernel against a running maximum, the plain
# version after normalizing) and rounds its output once. Per output
# element, with S = sum_t p_t |v_t| (the attention of |V|, fp32):
#   |out - ref| <= 2u S + 2u |ref| + (fp32 terms, ~1e-5 S),
# so BF16_REL = 8e-3 > 2u = 7.8125e-3 bounds every sound run. A dropped or
# doubled key tile, or a wrong page, moves a long row by the weight of the
# keys it touches, not by the rounding of all of them.
BF16_REL = 8e-3
TOLERANCE = {
    "float32": "|out - ref| <= 1e-5 + 1e-5 |ref|",
    "bfloat16": "|out - ref| <= 8e-3 (|ref| + S), S = attention of |V| "
                "(fp32) at the same element",
    "int8 pools": "the same two bounds, V dequantized in S; with bf16 q "
                  "only the plain version rounds p (the int8 programs, as "
                  "the Pallas ones, do not), which the bound's u S covers",
    "int8 pools, bf16 q, p unrounded": "against the plain version on "
                  "q.float(): |out - ref32| <= half a bf16 ulp of out + "
                  "4e-5 S; the plain version on bf16 q (p rounded) must "
                  "fail it on the timed inputs",
}
# bf16 q on an int8 pool: the int8 programs, as the Pallas ones, do not
# round p, so they are held as well to the plain version run on q.float()
# (p unrounded, fp32 output). Between the two lie the kernel's rounding of
# its output to bf16 (at most half a bf16 ulp of the output) and its
# hi + lo split of p·vs (<= 2^-16 per term: <= 1.6e-5 S), plus fp32
# reassociation: |out - ref32| <= half_ulp(out) + 4e-5 S. Rounding p to
# bf16 (u per term), as the plain version on bf16 q does and as a kernel
# with one bf16 P·V product would, moves a row by up to u S.
P_UNROUNDED_S = 4e-5
PROGRAM_LOGIT_MAE = 2e-2       # kernel vs gather programs, bf16, 24 layers
PROGRAM_INT8_LOGIT_MAE = 2e-2  # the same with int8 weights and KV

RECORD: dict = {"phases": []}
RECORD_PATH = "build/chip_smoke.json"


def emit(obj: dict) -> None:
    RECORD["phases"].append(obj)
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


SPIN_CYCLES_PER_S = 2.0e9   # at most the H100's SM clock: spins no shorter


def device_ms(fn, iters=30) -> float:
    """Device time of one call of fn: CUDA events around ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts the
    host's enqueueing of them all, so the device runs them back to back
    and the wrapper's host time does not count (it is of the order of a
    decode or flash-forward kernel's). The spin doubles until the end
    event of the spin is still pending when the last call is enqueued.
    Not torch.profiler's kernel sums: on the H100 they read some whole
    phases at 0.6x and single windows at 0.5x the same kernel's time."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.perf_counter() - t) / 3 + 1e-3
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        spun = not t0.query()
        torch.cuda.synchronize()
        if spun:
            return t0.elapsed_time(t1) / iters
        spin_s *= 2
    raise AssertionError("the host never enqueued the calls within the spin")


def kernel_ms(fn):
    """A kernel's time per call: its device time (``ms``, `device_ms`),
    and CUDA events around 30 calls as the host issues them
    (``ms_events``), which for a kernel of tens of microseconds read the
    wrapper's launch rate instead."""
    return device_ms(fn), cuda_time_ms(fn)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------- build

# The kernels that must be Hopper kernels: wgmma (HGMMA in the SASS) on
# tiles brought in by TMA (UTMALDG), and no mma.sync (HMMA); and the paged
# decode kernel, fed by TMA tensor loads as well (cuobjdump's UTMALDG; the
# non-tensor bulk copy it tried first is UBLKCP on the H100 with CUDA 12.8).
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "paged_prefill_wgmma_kernel",
                 "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel")
TMA_KERNELS = ("paged_decode_kernel",)
TMA_INSTANCES = 8      # {fp32, bf16} pools and int8 with {fp32, bf16} q, K 64/128
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
_MANGLED_ARGS = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16",
                 "Lb0E": "false", "Lb1E": "true"}


def kernel_name(sym: str) -> str:
    """A mangled kernel symbol → its name and template arguments, e.g.
    ``paged_prefill_wgmma_kernel<64,true>`` (the last name of the nested
    name, then the ints, bools and element types of its arguments)."""
    s, i, name = sym.removeprefix("_ZN"), 0, sym
    while (m := re.match(r"\d+", s[i:])):
        i += len(m.group())
        name, i = s[i:i + int(m.group())], i + int(m.group())
    end = s.find("EEv", i)
    if not s[i:].startswith("I") or end < 0:
        return name
    args = [_MANGLED_ARGS.get(t.group(), t.group()[2:-1]) for t in re.finditer(
        r"L[ib]\d+E|13__nv_bfloat16|[fa]", s[i + 1:end + 1])]
    return f"{name}<{','.join(args)}>"


def sass_ops(lib_path) -> dict:
    """Per kernel of the built library, which of SASS_OPS its SASS holds
    (``cuobjdump -sass``, beside nvcc). Raises unless every instance of
    WGMMA_KERNELS holds HGMMA and UTMALDG and no HMMA, and every one of the
    TMA_INSTANCES instances of TMA_KERNELS holds UTMALDG."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops: dict = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            ops.setdefault(fn, set())
        elif fn is not None:
            ops[fn].update(op for op in SASS_OPS if op in line)
    ops = {fn: sorted(v) for fn, v in sorted(ops.items())}
    hopper = {fn: v for fn, v in ops.items()
              if fn.split("<")[0] in WGMMA_KERNELS}
    if len(hopper) < 10 or any(v != ["HGMMA", "UTMALDG"]
                              for v in hopper.values()):
        raise AssertionError(f"the wgmma kernels' SASS lacks HGMMA or "
                             f"UTMALDG, or holds HMMA: {hopper}")
    decode = {fn: v for fn, v in ops.items()
              if fn.split("<")[0] in TMA_KERNELS}
    if len(decode) != TMA_INSTANCES or any("UTMALDG" not in v
                                           for v in decode.values()):
        raise AssertionError(f"the decode kernels' SASS lacks TMA loads "
                             f"(UTMALDG): {decode}")
    return ops


# ------------------------------------------------------------------ cases

def int8_plane(rows, device):
    """An int8 page plane and its bf16 scale vector from float rows
    [P, ps, H, K], quantized page by page with the port's own
    `_quant_write` (each page written from offset 0: its scale is its
    rows' max |x| / 127)."""
    n_pages, ps = rows.shape[:2]
    plane = torch.zeros(rows.shape, dtype=torch.int8, device=device)
    scale = torch.zeros(n_pages, dtype=torch.bfloat16, device=device)
    pages = torch.arange(n_pages, device=device).repeat_interleave(ps)
    offs = torch.arange(ps, device=device).repeat(n_pages)
    pk._quant_write(plane, scale, pages, offs, rows.flatten(0, 1))
    return plane, scale


def amplitude_rows(rng, n_pages, ps, heads, device):
    """Normal rows whose pages each have their own amplitude, log-uniform
    in [0.25, 4]: with equal amplitudes a wrong page's scale would barely
    move the output."""
    amp = np.exp(rng.uniform(np.log(0.25), np.log(4.0), n_pages))
    rows = rng.normal(size=(n_pages, ps, *heads)) * amp[:, None, None, None]
    return torch.from_numpy(rows.astype(np.float32)).to(device)


def paged_pool(rng, lengths, *, ps, n_pg, dtype, device, heads=(H, K),
               null_rows=(), quant=False):
    """K/V pools and a [B, n_pg] page table for slots of the given
    lengths. Each slot gets the pages its length needs (a length past the
    table, as an idle slot's cursor walks, fills it), drawn from a
    random permutation of the pool (the engine's pages are scattered);
    the rest of its row is the null page 0, and so is all of a row in
    null_rows (an idle slot, or a mid-prefill slot in a decode view).
    → (k_pool, v_pool, tables, lengths, scales): ``quant`` pools are int8
    from `amplitude_rows` with scales {"k_scale", "v_scale"}, float pools
    N(0, 1) in ``dtype`` with scales {}."""
    need = [0 if b in null_rows else min(-(-int(n) // ps), n_pg)
            for b, n in enumerate(lengths)]
    n_pages = sum(need) + 1
    if quant:
        kp, ks = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                            device)
        vp, vs = int8_plane(amplitude_rows(rng, n_pages, ps, heads, device),
                            device)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        kp, vp = (torch.from_numpy(rng.normal(
            size=(n_pages, ps, *heads)).astype(np.float32)).to(device, dtype)
            for _ in range(2))
        scales = {}
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((len(lengths), n_pg), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    return kp, vp, tables, np.asarray(lengths, np.int32), scales


def abs_v_attention(reference, q, kp, vp, *args, **scales):
    """S of the bf16 bound: the plain version with |V| in fp32 (an int8
    pool's |codes| with its scales)."""
    if scales:
        return reference(q.float(), kp, vp.abs(), *args, **scales)
    return reference(q.float(), kp.float(), vp.float().abs(), *args)


def check_close(name, out, ref, s_abs, dtype, live, long):
    """Hold the kernel's output to its plain version's on the elements of
    the live rows (``live``: a mask over the leading slot [, row] dims).
    → the largest error, the bound at that element and the largest share
    of the bound, over all live rows and over the long ones on their own
    (``long``: a mask like ``live``)."""
    o, r, s = (t.float()[live] for t in (out, ref, s_abs))
    lg = long[live]
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (o - r).abs()
    if dtype == torch.float32:
        tol = FP32_TOL["atol"] + FP32_TOL["rtol"] * r.abs()
    else:
        tol = BF16_REL * (r.abs() + s)
    share = torch.where(err == 0, torch.zeros_like(err), err / tol)
    worst = int(err.flatten().argmax())
    res = {"max_abs_err": float(err.max()),
           "bound_at_max_err": float(tol.flatten()[worst]),
           "max_share_of_bound": float(share.max()),
           "long_rows": int(lg.sum())}
    if bool(lg.any()):
        res["long_max_abs_err"] = float(err[lg].max())
        res["long_max_share_of_bound"] = float(share[lg].max())
        res["long_median_abs_ref"] = float(r[lg].abs().median())
        res["long_median_bound"] = float(tol[lg].median())
    if res["max_share_of_bound"] > 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: {res}")
    return res


def half_ulp_bf16(y):
    """Half the bf16 spacing at each element of y: the most by which
    rounding a value to bf16 can have moved it to y (0 at y = 0)."""
    y = y.float()
    _, e = torch.frexp(y)
    return torch.where(y == 0, torch.zeros_like(y),
                       torch.ldexp(torch.ones_like(y), e - 9))


def check_p_unrounded(name, out, ref32, p_rounded, s_abs, live, *,
                      fault_must_fail=False):
    """A bf16-q int8 program's output against ``ref32``, the plain
    version on q.float() (p unrounded), on the live rows; ``p_rounded``,
    the plain version on bf16 q, is a planted fault held to the same
    bound. → each one's largest share of 4e-5 S taken by its error beyond
    its output's own rounding (the bound holds iff the share <= 1)."""
    r, s = ref32.float()[live], s_abs.float()[live]

    def share(y):
        y = y.float()[live]
        excess = ((y - r).abs() - half_ulp_bf16(y)).clamp(min=0)
        return float(torch.where(excess == 0, torch.zeros_like(excess),
                                 excess / (P_UNROUNDED_S * s)).max())

    res = {"max_share_of_bound": share(out),
           "p_rounded_plain_share": share(p_rounded)}
    if res["max_share_of_bound"] > 1.0:
        raise AssertionError(f"{name}: the int8 program rounds p or "
                             f"disagrees with the unrounded plain version: "
                             f"{res}")
    if fault_must_fail and res["p_rounded_plain_share"] <= 1.0:
        raise AssertionError(f"{name}: p rounded to bf16 passes the "
                             f"unrounded bound: {res}")
    return res


def check_decode(rng, tag, lengths, *, ps, n_pg, dtype, device, heads,
                 null_rows=(), quant=False):
    kp, vp, tables, lengths, sc = paged_pool(
        rng, lengths, ps=ps, n_pg=n_pg, dtype=dtype, device=device,
        heads=heads, null_rows=null_rows, quant=quant)
    q = torch.from_numpy(rng.normal(size=(len(lengths), *heads)).astype(
        np.float32)).to(device, dtype)
    args = [torch.from_numpy(a).to(device) for a in (tables, lengths)]
    out = pa.paged_attention(q, kp, vp, *args, **sc)
    again = pa.paged_attention(q, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"decode {tag}: a repeat call gave other bits")
    ref = pa.reference_paged_attention(q, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_attention, q, kp, vp, *args,
                            **sc)
    # A slot of length 0: zeros from the kernel (its l == 0 guard), the
    # uniform average of V from the gather version, by definition.
    live = args[1] > 0
    if not torch.all(out[~live].float() == 0):
        raise AssertionError(f"decode {tag}: a length-0 slot not zero")
    long = args[1] >= LONG_ROW
    res = check_close(f"decode {tag}", out, ref, s_abs, dtype, live, long)
    if quant and dtype == torch.bfloat16:
        res["p_unrounded"] = check_p_unrounded(
            f"decode {tag}", out, pa.reference_paged_attention(
                q.float(), kp, vp, *args, **sc), ref, s_abs, live)
    n_sm = pa._sm_count(device)
    res["n_split"] = pa.decode_splits(len(lengths), heads[0], n_pg, n_sm)
    res["n_parts"] = pa.decode_live_splits(
        lengths, ps, n_pg, heads[0], res["n_split"],
        pa.decode_stage_rows(heads[1], kp.element_size()), n_sm)
    return res


def split_edge_lengths(n_split, ps):
    """Seven slot lengths at the decode kernel's split edges on a CAP-
    position table, for a grid of n_split splits per slot: n_split·ps·k
    (on a page boundary that is a split's end when the slot uses all
    n_split), one past and one short of it, n_split - 1 live pages, a
    length past the table (an idle slot's cursor), 0, and 1 (the idle
    slot on the null page: null_rows {6})."""
    whole = n_split * ps * max(1, CAP // (n_split * ps))
    return [whole, whole + 1, whole - 1, (n_split - 1) * ps, CAP + 100, 0, 1]


def check_prefill(rng, tag, rows, C, *, ps, n_pg, width, dtype, device,
                  heads, quant=False):
    """rows: (offset, valid tokens) per slot; (0, 0) is an inert row with
    an all-null table. The pool has the pages of n_pg·ps positions; the
    kernel gets the first ``width`` pages of the table."""
    lens = [o + n for o, n in rows]
    inert = {b for b, n in enumerate(lens) if n == 0}
    kp, vp, tables, lens, sc = paged_pool(
        rng, [n_pg * ps if n else 0 for n in lens], ps=ps, n_pg=n_pg,
        dtype=dtype, device=device, heads=heads, null_rows=inert,
        quant=quant)
    lens = np.array([o + n for o, n in rows], np.int32)
    offs = np.array([o for o, _ in rows], np.int32)
    q = torch.from_numpy(rng.normal(size=(len(rows), C, *heads)).astype(
        np.float32)).to(device, dtype)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (tables[:, :width], offs, lens)]
    out = pa.paged_prefill_attention(q, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    ref = pa.reference_paged_prefill_attention(q, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_prefill_attention,
                            q, kp, vp, *args, **sc)
    # Inert rows (lengths 0) are defined differently by the kernel
    # (zeros, the l == 0 guard) and the gather version (mean of V).
    live_slot = args[2] > 0
    if not torch.all(out[~live_slot].float() == 0):
        raise AssertionError(f"prefill {tag}: inert row not zero")
    c = torch.arange(C, device=device)
    attended = torch.minimum(args[2][:, None], args[1][:, None] + c + 1)
    live = live_slot[:, None].expand(-1, C)
    res = check_close(f"prefill {tag}", out, ref, s_abs, dtype, live,
                      attended >= LONG_ROW)
    if quant and dtype == torch.bfloat16:
        res["p_unrounded"] = check_p_unrounded(
            f"prefill {tag}", out, pa.reference_paged_prefill_attention(
                q.float(), kp, vp, *args, **sc), ref, s_abs, live)
    return res


def phase_kernels(device, errs):
    """Each kernel against its plain version, the float programs and then
    the int8 ones (int8 pools from `amplitude_rows`, quantized by the
    port's `_quant_write`): OPT-1.3B's heads at page sizes 16 and 64 in
    fp32 and bf16, then head dim 128 (the kernels' other tensor-core and
    vector-width instantiation; at both page sizes for int8). Cases: the
    ragged edge cases on a narrow table; the engine's decode view (16
    slots, a table of CAP positions, ragged lengths up to CAP, an idle and
    a mid-prefill slot); prefill chunks at ragged offsets, full and width-
    sliced tables, C=256 (the engine's chunk) and C=40 (a partial query
    tile); and the engine's prefill dispatches (16 rows of 256, most of
    them inert)."""
    rng = np.random.default_rng(0)
    cases = []
    dts = (torch.float32, torch.bfloat16)
    grid = [((H, K), ps, dt, False) for ps in (16, 64) for dt in dts]
    grid += [((16, 128), 64, dt, False) for dt in dts]
    grid += [(heads, ps, dt, True) for heads in ((H, K), (16, 128))
             for ps in (16, 64) for dt in dts]

    def record(kernel, tag, res):
        errs[kernel] = max(errs[kernel], res["max_abs_err"])
        cases.append({"kernel": kernel, "case": tag, **res})

    for heads, ps, dtype, quant in grid:
        dn = str(dtype).split(".")[1]
        kw = dict(ps=ps, dtype=dtype, device=device, heads=heads,
                  quant=quant)
        sfx = "_int8" if quant else ""
        tag = (f"ps={ps} {dn} heads={heads[0]}x{heads[1]}"
               f"{' int8 pool' if quant else ''}")
        # Decode: length 1, mid-page, page boundary, full table, and an
        # idle slot (length 1 on the null page), table 4 pages wide.
        record("paged_attention" + sfx, f"{tag} edge cases", check_decode(
            rng, tag, [1, ps // 2 + 1, ps, 4 * ps, 1], n_pg=4,
            null_rows={4}, **kw))
        # Decode as the engine runs it: 16 slots, the full table of CAP
        # positions, the last two slots idle and mid-prefill (zeroed
        # row, a length past the null page's).
        n_pg = CAP // ps
        lengths = [1, ps // 2 + 1, ps, ps + 1, 700, 1023, 1024, 1025, 1531,
                   1999, CAP - ps, CAP - ps + 1, CAP - 1, CAP, 1, 1000]
        record("paged_attention" + sfx, f"{tag} engine view B=16 n_pg={n_pg}",
               check_decode(rng, tag, lengths, n_pg=n_pg,
                            null_rows={14, 15}, **kw))
        # The split paths: one slot at CAP (the most splits), the light-
        # load view (2 of 16 slots live at CAP, 14 idle on the null page),
        # and seven slots at the split edges (`split_edge_lengths`).
        record("paged_attention" + sfx, f"{tag} B=1 at {CAP}", check_decode(
            rng, tag, [CAP], n_pg=n_pg, **kw))
        record("paged_attention" + sfx, f"{tag} light load", check_decode(
            rng, tag, [CAP] * 2 + [1] * 14, n_pg=n_pg,
            null_rows=set(range(2, 16)), **kw))
        edges = split_edge_lengths(pa.decode_splits(
            7, heads[0], n_pg, pa._sm_count(device)), ps)
        record("paged_attention" + sfx, f"{tag} split edges {edges}",
               check_decode(rng, tag, edges, n_pg=n_pg, null_rows={6}, **kw))
        # Prefill: chunk rows at ragged offsets against a 1536-token
        # table, full width and width-sliced; C=256 and C=40.
        n_pg = 1536 // ps
        for C, width in ((256, n_pg), (256, n_pg // 2), (40, n_pg // 2)):
            cap = width * ps
            rows = [(0, C), (ps, C), (cap - C, C), (ps + 3, 1),
                    (cap - 40, 40), (0, 0)]   # last: inert row
            ptag = f"{tag} C={C} width={width}"
            record("paged_prefill_attention" + sfx, ptag, check_prefill(
                rng, ptag, rows, C, n_pg=n_pg, width=width, **kw))
        # Prefill as the engine dispatches it: [16, 256] with the live
        # rows first and the rest inert, at the pow-2 width of the
        # bucket (chunks ending past 1024 positions, then within 512).
        for width_tokens, live_rows in (
                (CAP, [(1024, 256), (1280, 256), (1536, 37), (1792, 255)]),
                (512, [(0, 256), (256, 256), (0, 77)])):
            rows = live_rows + [(0, 0)] * (16 - len(live_rows))
            n_pg = width_tokens // ps
            ptag = f"{tag} engine dispatch 16x256 width={n_pg}"
            record("paged_prefill_attention" + sfx, ptag, check_prefill(
                rng, ptag, rows, 256, n_pg=n_pg, width=n_pg, **kw))
    # Decode at ps 8, below a stage's positions for every program (bf16
    # 16, int8 32 at head dim 64), on the engine view's lengths.
    for quant in (False, True):
        lengths = [1, 5, 8, 9, 700, 1023, 1024, 1025, CAP - 1, CAP, 0, 1]
        record("paged_attention" + ("_int8" if quant else ""),
               f"ps=8 bfloat16 heads={H}x{K}{' int8 pool' if quant else ''}",
               check_decode(rng, "ps=8", lengths, ps=8, n_pg=CAP // 8,
                            dtype=torch.bfloat16, device=device,
                            heads=(H, K), null_rows={10, 11}, quant=quant))
    # bf16 q at every page size the wgmma prefill kernel takes in boxes of
    # its own (16, 32: several pages per key tile; 64; 128: a page of two
    # key tiles at head dim 128) and at 48, which the mma.sync kernel
    # takes by the shape rule; chunks of C = 40, 72 and 200 at ragged
    # offsets on a width-sliced table, with an inert row.
    for heads in ((H, K), (16, 128)):
        for ps in (16, 32, 64, 128, 48):
            for quant in (False, True):
                n_pg = -(-768 // ps)
                width = n_pg - 1
                cap = width * ps
                sfx = "_int8" if quant else ""
                kern = pa.prefill_kernel(torch.bfloat16, heads[1], ps)
                for C in (40, 72, 200):
                    rows = [(0, C), (ps + 3, C - 5), (cap - C, C), (11, 1),
                            (0, 0)]
                    ptag = (f"ps={ps} bfloat16 heads={heads[0]}x{heads[1]}"
                            f"{' int8 pool' if quant else ''} C={C} "
                            f"width={width} ({kern} kernel)")
                    record("paged_prefill_attention" + sfx, ptag,
                           check_prefill(rng, ptag, rows, C, ps=ps,
                                         n_pg=n_pg, width=width,
                                         dtype=torch.bfloat16, device=device,
                                         heads=heads, quant=quant))
    emit({"phase": "kernels_vs_plain", "tolerance": TOLERANCE,
          "cases": cases})
    return {**time_kernels(device, errs), **time_int8_kernels(device, errs)}


def sdpa_prefill(qp, kt, vt, off):
    """SDPA yardsticks of a prefill chunk at offset ``off`` (q [B, C, H,
    K] against the gathered [B, H, T, K] timeline), by device time with
    CUDA events beside it: with a bool mask, and with
    causal_lower_right(C, T), exactly the prefill mask at offset T - C,
    which may take a flash backend. ``library_ms`` is the faster."""
    from torch.nn.attention.bias import causal_lower_right

    C, T = qp.shape[1], kt.shape[2]
    assert off == T - C, (off, T, C)
    qpt = qp.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=qp.device)[None, :]
            <= (off + torch.arange(C, device=qp.device))[:, None])
    lower_right = causal_lower_right(C, T)
    bool_ms, bool_ev = kernel_ms(lambda: F.scaled_dot_product_attention(
        qpt, kt, vt, attn_mask=mask))
    lr_ms, lr_ev = kernel_ms(lambda: F.scaled_dot_product_attention(
        qpt, kt, vt, attn_mask=lower_right))
    return {"library_ms": min(bool_ms, lr_ms),
            "library_call": ("causal_lower_right" if lr_ms <= bool_ms
                             else "bool mask"),
            "sdpa_bool_mask_ms": bool_ms, "sdpa_bool_mask_ms_events": bool_ev,
            "sdpa_lower_right_ms": lr_ms, "sdpa_lower_right_ms_events": lr_ev}


def host_us(fn, n=200) -> float:
    """The host's time per call of fn in µs, over n calls issued without a
    synchronisation (the wrapper's Python, checks, allocations and
    launches; the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


LIGHT_SLOTS, LIGHT_LIVE = 16, 2    # light load: 2 of the 16-slot view live


def light_load_case(rng, device, *, quant):
    """The engine's 16-slot decode view at light load, ps 64: slots 0 and
    1 live at CAP positions (a full CAP-position table), the other 14 idle
    on the null page (length 1), bf16 q. → (q, k_pool, v_pool, tables,
    lengths, scales, live)"""
    ps = 64
    lengths = [CAP] * LIGHT_LIVE + [1] * (LIGHT_SLOTS - LIGHT_LIVE)
    kp, vp, tables, lengths, sc = paged_pool(
        rng, lengths, ps=ps, n_pg=CAP // ps, dtype=torch.bfloat16,
        device=device, heads=(H, K),
        null_rows=set(range(LIGHT_LIVE, LIGHT_SLOTS)), quant=quant)
    q = torch.from_numpy(rng.normal(size=(LIGHT_SLOTS, H, K)).astype(
        np.float32)).to(device, torch.bfloat16)
    tables, lengths = (torch.from_numpy(a).to(device)
                       for a in (tables, lengths))
    live = torch.arange(LIGHT_SLOTS, device=device) < LIGHT_LIVE
    return q, kp, vp, tables, lengths, sc, live


def time_decode(tag, q, kp, vp, tables, lengths, sc, live):
    """One decode shape: the kernel held to its plain version on every
    slot (with bf16 q on an int8 pool also to the unrounded plain
    version, which the p-rounded one must fail), a repeat call held to
    the same bits; then its device time beside its bound (the positions
    each slot reads, min(length, table), and their pages' scales), its
    plain version, SDPA on the ``live`` slots' gathered timelines (whole
    tables, so no mask; an int8 pool's dequantized to bf16, not timed) and
    the wrapper's host time per call. → the timing record."""
    dt = q.dtype
    args = (tables, lengths)
    call = lambda: pa.paged_attention(q, kp, vp, *args, **sc)
    out = call()
    torch.cuda.synchronize()
    ref = pa.reference_paged_attention(q, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_attention, q, kp, vp, *args,
                            **sc)
    every = torch.ones(len(q), dtype=torch.bool, device=q.device)
    check = check_close(f"decode {tag}", out, ref, s_abs, dt, every,
                        lengths >= LONG_ROW)
    if sc and dt == torch.bfloat16:
        check["p_unrounded"] = check_p_unrounded(
            f"decode {tag}", out, pa.reference_paged_attention(
                q.float(), kp, vp, *args, **sc), ref, s_abs, every,
            fault_must_fail=True)
    if not torch.equal(out, call()):
        raise AssertionError(f"decode {tag}: a repeat call gave other bits")
    ms, ms_events = kernel_ms(call)
    plain = cuda_time_ms(lambda: pa.reference_paged_attention(
        q, kp, vp, *args, **sc), iters=10)
    B, n_pg, ps = len(q), tables.shape[1], kp.shape[1]
    if not bool((lengths[live] == n_pg * ps).all()):
        raise AssertionError("SDPA's yardstick takes whole tables")
    kt, vt = pa._gather_timeline(kp, vp, tables[live], sc.get("k_scale"),
                                 sc.get("v_scale"))
    kt, vt = (x.transpose(1, 2).to(dt).contiguous() for x in (kt, vt))
    qs = q[live][:, :, None, :]
    lib = device_ms(lambda: F.scaled_dot_product_attention(qs, kt, vt))
    seen = lengths.clamp(min=0, max=n_pg * ps)
    rows = int(seen.sum())
    pages = int(((seen + ps - 1) // ps).sum())
    nbytes = (2 * rows * H * K * kp.element_size()
              + 2 * q.numel() * q.element_size() + tables.numel() * 4
              + B * 4 + (2 * pages * 2 if sc else 0))
    bms, by = bound_ms(nbytes, 4 * rows * H * K, BF16_FLOPS)
    n_sm = pa._sm_count(q.device)
    n_split = pa.decode_splits(B, H, n_pg, n_sm)
    n_parts = pa.decode_live_splits(lengths.tolist(), ps, n_pg, H, n_split,
                                    pa.decode_stage_rows(K, kp.element_size()),
                                    n_sm)
    return dict(
        ms=ms, ms_events=ms_events, plain_ms=plain, library_ms=lib,
        bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
        host_us=host_us(call), n_split=n_split, n_parts=n_parts,
        bytes=nbytes, check=check,
        shape=(f"B={B} ({int(live.sum())} live) H={H} K={K} n_pg={n_pg} "
               f"ps={ps} {str(dt).split('.')[1]} q"
               f"{', int8 pool' if sc else ''}"))


def time_kernels(device, errs):
    """Kernel, plain version and SDPA at the main path's decode and
    prefill shapes: B=16 slots, 1024-token contexts, ps=64, bf16; the
    decode kernel also at light load (`light_load_case`). Each kernel's
    output is first held to its plain version's on these inputs."""
    rng = np.random.default_rng(1)
    B, T, ps, dt = 16, 1024, 64, torch.bfloat16
    n_pg = T // ps
    n_pages = B * n_pg + 1
    kp = torch.randn(n_pages, ps, H, K, device=device, dtype=dt)
    vp = torch.randn(n_pages, ps, H, K, device=device, dtype=dt)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(B, n_pg)).to(device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    kt, vt = pa._gather_timeline(kp, vp, tables)       # [B, T, H, K]
    kt = kt.transpose(1, 2).contiguous()               # [B, H, T, K]
    vt = vt.transpose(1, 2).contiguous()
    item = 2
    timings = {}

    q = torch.randn(B, H, K, device=device, dtype=dt)
    every = torch.ones(B, dtype=torch.bool, device=device)
    timings["paged_attention"] = time_decode(
        "timing shape", q, kp, vp, tables, lengths, {}, every)
    timings["paged_attention_light_load"] = time_decode(
        "light load", *light_load_case(rng, device, quant=False))
    errs["paged_attention"] = max(
        errs["paged_attention"], *(timings[k]["check"]["max_abs_err"] for k in
                                   ("paged_attention",
                                    "paged_attention_light_load")))

    C, off = 256, T - 256
    qp = torch.randn(B, C, H, K, device=device, dtype=dt)
    offs = torch.full((B,), off, dtype=torch.int32, device=device)
    args = (tables, offs, lengths)
    out = pa.paged_prefill_attention(qp, kp, vp, *args)
    torch.cuda.synchronize()
    attended = torch.minimum(
        lengths[:, None], offs[:, None] + torch.arange(C, device=device) + 1)
    check = check_close(
        "prefill timing shape", out, pa.reference_paged_prefill_attention(
            qp, kp, vp, *args), abs_v_attention(
            pa.reference_paged_prefill_attention, qp, kp, vp, *args), dt,
        torch.ones(B, C, dtype=torch.bool, device=device),
        attended >= LONG_ROW)
    errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"],
                                          check["max_abs_err"])
    ms, ms_events = kernel_ms(lambda: pa.paged_prefill_attention(
        qp, kp, vp, *args))
    plain = cuda_time_ms(lambda: pa.reference_paged_prefill_attention(
        qp, kp, vp, *args), iters=5)
    sdpa = sdpa_prefill(qp, kt, vt, off)
    nbytes = (2 * B * T * H * K * item + 2 * B * C * H * K * item
              + tables.numel() * 4 + 2 * B * 4)
    attended = sum(off + c + 1 for c in range(C))
    flops = 4 * B * H * K * attended
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    timings["paged_prefill_attention"] = dict(
        ms=ms, ms_events=ms_events, plain_ms=plain, **sdpa,
        bound_ms=bms, bound_by=by,
        check=check,
        shape=f"B={B} C={C} H={H} K={K} ctx={T} offset={off} ps={ps} bf16")
    emit({"phase": "kernel_timing", **timings})
    return timings


def share_of_bound(out, ref, s_abs):
    """Largest |out - ref| / (8e-3 (|ref| + S)), the bf16 bound's share
    (0 where out equals ref: a row of zeros, as an idle slot's on an
    unwritten null page, has a bound of 0)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    share = err / (BF16_REL * (r.abs() + s_abs))
    return float(torch.where(err == 0, torch.zeros_like(share), share).max())


def planted_int8_faults(reference, q, kp, vp, tables, args, scales, *,
                        shift_offsets):
    """The bf16 bound against a wrong plain version on the timed inputs
    (``args``: the index arrays after the table) → each fault's largest
    share of the bound, which must exceed 1:
    - the scales indexed by table position j instead of page id: the
      plain version given scale vectors s' with s'[tables[b, j]] = s[j];
    - one page dropped: page 1 of every slot taken out of its table (the
      rest moved up, a null page appended, lengths and, for prefill, the
      offsets moved back by one page; decode has no positions)."""
    ps = kp.shape[1]
    ref = reference(q, kp, vp, tables, *args, **scales)
    s_abs = abs_v_attention(reference, q, kp, vp, tables, *args, **scales)
    by_pos = {}
    B, n_pg = tables.shape
    idx = tables.long().flatten()
    for name, sc in scales.items():
        fake = sc.clone()
        fake[idx] = sc[torch.arange(n_pg, device=sc.device).repeat(B)]
        by_pos[name] = fake
    dropped = torch.cat([tables[:, :1], tables[:, 2:],
                         torch.zeros_like(tables[:, :1])], dim=1)
    moved = [a - ps for a in args] if shift_offsets else [args[0] - ps]
    out = {
        "scale by table position": share_of_bound(
            reference(q, kp, vp, tables, *args, **by_pos), ref, s_abs),
        "page 1 dropped": share_of_bound(
            reference(q, kp, vp, dropped, *moved, **scales), ref, s_abs),
    }
    if min(out.values()) <= 1.0:
        raise AssertionError(f"a planted fault passes the bf16 bound: {out}")
    return out


P_ROUNDED_FAULT = "p rounded to bf16 (the plain version on bf16 q)"


def time_int8_kernels(device, errs):
    """The int8 programs at the float kernels' timed shapes (B=16 slots,
    1024-token contexts, ps=64, bf16 q), the decode program also at light
    load (`light_load_case`), on int8 pools from
    `amplitude_rows`: each held once more to its plain version, two
    planted faults in the plain version held to the same bound, then
    timed beside its bound, its plain version and SDPA on the gathered
    timeline dequantized to bf16 (the dequantization not timed)."""
    rng = np.random.default_rng(6)
    B, T, ps, dt = 16, 1024, 64, torch.bfloat16
    n_pg = T // ps
    n_pages = B * n_pg + 1
    kp, ks = int8_plane(amplitude_rows(rng, n_pages, ps, (H, K), device),
                        device)
    vp, vs = int8_plane(amplitude_rows(rng, n_pages, ps, (H, K), device),
                        device)
    sc = {"k_scale": ks, "v_scale": vs}
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(B, n_pg)).to(device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    kt, vt = pa._gather_timeline(kp, vp, tables, ks, vs)   # fp32 [B, T, H, K]
    kt = kt.transpose(1, 2).to(dt).contiguous()            # [B, H, T, K]
    vt = vt.transpose(1, 2).to(dt).contiguous()
    scale_bytes = 2 * B * n_pg * 2       # one bf16 K and V scale per page
    timings, planted = {}, {}

    q = torch.from_numpy(rng.normal(size=(B, H, K)).astype(np.float32)).to(
        device, dt)
    every = torch.ones(B, dtype=torch.bool, device=device)
    timings["paged_attention_int8"] = time_decode(
        "int8 timing shape", q, kp, vp, tables, lengths, sc, every)
    timings["paged_attention_int8_light_load"] = time_decode(
        "int8 light load", *light_load_case(rng, device, quant=True))
    check = timings["paged_attention_int8"]["check"]
    errs["paged_attention_int8"] = max(
        errs["paged_attention_int8"], check["max_abs_err"],
        timings["paged_attention_int8_light_load"]["check"]["max_abs_err"])
    planted["paged_attention_int8"] = {
        **planted_int8_faults(pa.reference_paged_attention, q, kp, vp,
                              tables, (lengths,), sc, shift_offsets=False),
        P_ROUNDED_FAULT: check["p_unrounded"]["p_rounded_plain_share"]}

    C, off = 256, T - 256
    qp = torch.from_numpy(rng.normal(size=(B, C, H, K)).astype(
        np.float32)).to(device, dt)
    offs = torch.full((B,), off, dtype=torch.int32, device=device)
    args = (tables, offs, lengths)
    out = pa.paged_prefill_attention(qp, kp, vp, *args, **sc)
    torch.cuda.synchronize()
    attended = torch.minimum(
        lengths[:, None], offs[:, None] + torch.arange(C, device=device) + 1)
    ref = pa.reference_paged_prefill_attention(qp, kp, vp, *args, **sc)
    s_abs = abs_v_attention(pa.reference_paged_prefill_attention, qp, kp, vp,
                            *args, **sc)
    every = torch.ones(B, C, dtype=torch.bool, device=device)
    check = check_close("prefill int8 timing shape", out, ref, s_abs, dt,
                        every, attended >= LONG_ROW)
    check["p_unrounded"] = check_p_unrounded(
        "prefill int8 timing shape", out,
        pa.reference_paged_prefill_attention(qp.float(), kp, vp, *args,
                                             **sc), ref, s_abs, every,
        fault_must_fail=True)
    errs["paged_prefill_attention_int8"] = max(
        errs["paged_prefill_attention_int8"], check["max_abs_err"])
    planted["paged_prefill_attention_int8"] = {
        **planted_int8_faults(pa.reference_paged_prefill_attention, qp, kp,
                              vp, tables, (offs, lengths), sc,
                              shift_offsets=True),
        P_ROUNDED_FAULT: check["p_unrounded"]["p_rounded_plain_share"]}
    ms, ms_events = kernel_ms(lambda: pa.paged_prefill_attention(
        qp, kp, vp, *args, **sc))
    plain = cuda_time_ms(lambda: pa.reference_paged_prefill_attention(
        qp, kp, vp, *args, **sc), iters=5)
    sdpa = sdpa_prefill(qp, kt, vt, off)
    nbytes = (2 * B * T * H * K + 2 * B * C * H * K * 2 + scale_bytes
              + tables.numel() * 4 + 2 * B * 4)
    flops = 4 * B * H * K * sum(off + c + 1 for c in range(C))
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    timings["paged_prefill_attention_int8"] = dict(
        ms=ms, ms_events=ms_events, plain_ms=plain, **sdpa,
        bound_ms=bms, bound_by=by,
        bytes=nbytes, flops=flops, check=check,
        shape=f"B={B} C={C} H={H} K={K} ctx={T} offset={off} ps={ps} "
              "bf16 q, int8 pool")
    emit({"phase": "int8_kernel_timing", **timings,
          "planted_faults_vs_bf16_bound": planted,
          "note": f"{P_ROUNDED_FAULT!r} is read against the p-unrounded "
                  "bound (share of 4e-5 S beyond the output's rounding), "
                  "the other faults against the bf16 bound"})
    return timings


# ------------------------------------------------------------ flash kernels
#
# The same bound as the paged kernels'. Forward: S = the attention of |V|.
# Backward: each side computes ds (or p) in fp32 and rounds it to bf16
# before its product, so with W = p (|dP| + |delta|) sm_scale >= |ds|:
#   dq: S = W |K|,  dk: S = W^T |Q|,  dv: S = p^T |dO|   (all fp32),
# and |out - ref| <= 2u (|ref| + S) + (fp32 terms) <= 8e-3 (|ref| + S).

FLASH_SHAPE = (8, 1024, 12, 64)    # the training step's q, k, v [B, S, H, K]
FLASH_LONG = 512     # visible keys (rows) from which a flash row (key) is long
FAULT_LO = 512       # first key (row) of the tile a planted fault drops
FLASH_TOLERANCE = {
    "float32": TOLERANCE["float32"],
    "bfloat16": "|out - ref| <= 8e-3 (|ref| + S); S = attention of |V| (o),"
                " W |K| (dq), W^T |Q| (dk), p^T |dO| (dv), W = p (|dP| + "
                "|delta|) sm_scale, all fp32; lse within 1e-4",
}


def flash_inputs(rng, B, S, T, Hh, Kd, dtype, device):
    """q, k, v, dO and an lse cotangent, N(0, 1) from ``rng``; o and lse
    from the plain forward, so the backward kernels and their plain
    versions see the same saved tensors."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)
    q, k, v = (t(B, n, Hh, Kd).to(dtype) for n in (S, T, T))
    do = t(B, S, Hh, Kd).to(dtype)
    dlse = t(B, S, Hh)
    return q, k, v, do, dlse


def flash_abs_sums(q, k, v, do, lse, delta, causal, scale):
    """S of the bf16 bound for o, dq, dk and dv (see above), in fp32."""
    S_, T_ = q.shape[1], k.shape[1]
    s = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    mask = torch.ones(S_, T_, dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(S_, device=q.device)[:, None] >= torch.arange(
            T_, device=q.device)[None, :]
    row = lambda x: x.transpose(1, 2)[..., None]
    p = torch.where(mask, torch.exp(s - row(lse)), torch.zeros_like(s))
    dp = torch.einsum("bshk,bthk->bhst", do.float(), v.float())
    w = p * (dp.abs() + row(delta).abs()) * scale
    del s, dp
    s_o, _ = fa.reference_flash_fwd(q.float(), k.float(), v.float().abs(),
                                    causal, scale)
    return {
        "flash_fwd": s_o,
        "flash_dq": torch.einsum("bhst,bthk->bshk", w, k.float().abs()),
        "flash_dk": torch.einsum("bhst,bshk->bthk", w, q.float().abs()),
        "flash_dv": torch.einsum("bhst,bshk->bthk", p, do.float().abs()),
    }


def flash_close(name, out, ref, s_abs, dtype, long):
    """check_close over every element (no inert rows here); ``long``
    [S] or [T] marks the long rows (or keys) of every batch entry."""
    every = torch.ones(out.shape[:2], dtype=torch.bool, device=out.device)
    return check_close(name, out, ref, s_abs, dtype, every, every & long)


def flash_long(S, T, causal, device):
    """Rows with FLASH_LONG or more visible keys, keys visible to
    FLASH_LONG or more rows → ([S], [T]) bool."""
    s, t = torch.arange(S, device=device), torch.arange(T, device=device)
    rows = torch.clamp(s + 1, max=T) if causal else torch.full_like(s, T)
    keys = torch.clamp(S - t, min=0) if causal else torch.full_like(t, S)
    return rows >= FLASH_LONG, keys >= FLASH_LONG


def dropped_tile(q, k, v, do, lse, delta, scale, lo):
    """What one 64-wide tile adds to each causal gradient, from the plain
    version's rounded p and ds in fp32: keys lo..lo+63 to dq, query rows
    lo..lo+63 to dk and dv. A planted fault subtracts it."""
    hi = lo + 64
    p, ds = fa._p_ds(q, k, v, do, lse, delta, True, scale)
    dq = torch.einsum("bhst,bthk->bshk", ds[..., lo:hi].float(),
                      k[:, lo:hi].float())
    dk = torch.einsum("bhst,bshk->bthk", ds[:, :, lo:hi].float(),
                      q[:, lo:hi].float())
    dv = torch.einsum("bhst,bshk->bthk", p[:, :, lo:hi].to(do.dtype).float(),
                      do[:, lo:hi].float())
    return dq, dk, dv


def planted_flash_faults(q, k, v, do, lse, delta, scale):
    """The bf16 bound against a wrong backward on the timed inputs: the
    plain dq with keys 512-575 dropped, the plain dk and dv with query
    rows 512-575 dropped → each fault's largest share of the bound, over
    every element and over the long rows (or keys). Each must exceed 1."""
    tiles = dict(zip(("flash_dq", "flash_dk", "flash_dv"),
                     dropped_tile(q, k, v, do, lse, delta, scale, FAULT_LO)))
    refs = dict(zip(("flash_dk", "flash_dv"), fa.reference_flash_dkv(
        q, k, v, do, lse, delta, True, scale)))
    refs["flash_dq"] = fa.reference_flash_dq(q, k, v, do, lse, delta, True,
                                             scale)
    sums = flash_abs_sums(q, k, v, do, lse, delta, True, scale)
    long_q, long_k = flash_long(q.shape[1], k.shape[1], True, q.device)
    out = {"dropped": f"dq: keys {FAULT_LO}-{FAULT_LO + 63}; dk, dv: query "
                      f"rows {FAULT_LO}-{FAULT_LO + 63}"}
    for name, tile in tiles.items():
        ref = refs[name].float()
        wrong = (ref - tile).to(q.dtype).float()
        share = (wrong - ref).abs() / (BF16_REL * (ref.abs() + sums[name]))
        long = long_q if name == "flash_dq" else long_k
        out[name] = {"max_share_of_bound": float(share.max()),
                     "long_max_share_of_bound": float(share[:, long].max())}
        if out[name]["max_share_of_bound"] <= 1.0:
            raise AssertionError(f"planted fault passes the bf16 bound: {out}")
    return out


def packed_views(q, k, v):
    """q, k, v as views of packed [B, S, 3, H, K] tensors (q of one, k and
    v of another), as the training step's qkv projection passes them."""
    qkv_q = torch.empty(*q.shape[:2], 3, *q.shape[2:], dtype=q.dtype,
                        device=q.device)
    qkv_kv = torch.empty(*k.shape[:2], 3, *k.shape[2:], dtype=k.dtype,
                         device=k.device)
    qkv_q[:, :, 0] = q
    qkv_kv[:, :, 1] = k
    qkv_kv[:, :, 2] = v
    return qkv_q[:, :, 0], qkv_kv[:, :, 1], qkv_kv[:, :, 2]


def check_flash(rng, tag, B, S, T, Hh, Kd, dtype, causal, device,
                packed=False):
    """Each flash kernel against its plain version on one case →
    {kernel: result}. The backward gets an lse cotangent. ``packed``: q,
    k and v are strided views of packed qkv tensors."""
    scale = 1.0 / np.sqrt(Kd)
    long_q, long_k = flash_long(S, T, causal, device)
    q, k, v, do, dlse = flash_inputs(rng, B, S, T, Hh, Kd, dtype, device)
    if packed:
        q, k, v = packed_views(q, k, v)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.reference_flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(o_ref, do, dlse)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    dq_ref = fa.reference_flash_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk_ref, dv_ref = fa.reference_flash_dkv(q, k, v, do, lse_ref, delta,
                                            causal, scale)
    sums = flash_abs_sums(q, k, v, do, lse_ref, delta, causal, scale)
    # Outputs take their inputs' layout (torch.empty_like: the same
    # strides for a dense input, contiguous for a packed view).
    like = lambda x: torch.empty_like(x).stride()
    if not (dq.stride() == like(q) and dk.stride() == like(k)
            and dv.stride() == like(v) and o.stride() == like(q)):
        raise AssertionError(f"flash {tag}: outputs lost their inputs' layout")
    res = {"flash_fwd": flash_close(f"flash_fwd {tag}", o, o_ref,
                                    sums["flash_fwd"], dtype, long_q)}
    # lse: fp32 on both sides from the same fp32 statistics.
    lse_err = float((lse - lse_ref).abs().max())
    res["flash_fwd"]["lse_max_abs_err"] = lse_err
    if lse_err > 1e-4:
        raise AssertionError(f"flash_fwd {tag}: lse off by {lse_err}")
    res["flash_dq"] = flash_close(f"flash_dq {tag}", dq, dq_ref,
                                  sums["flash_dq"], dtype, long_q)
    rk = flash_close(f"flash_dkv dk {tag}", dk, dk_ref, sums["flash_dk"],
                     dtype, long_k)
    rv = flash_close(f"flash_dkv dv {tag}", dv, dv_ref, sums["flash_dv"],
                     dtype, long_k)
    res["flash_dkv"] = {
        "max_abs_err": max(rk["max_abs_err"], rv["max_abs_err"]),
        "max_share_of_bound": max(rk["max_share_of_bound"],
                                  rv["max_share_of_bound"]),
        "dk": rk, "dv": rv}
    return res


def phase_flash_kernels(device, errs):
    """The three flash kernels against their plain versions: fp32 and
    bf16, head dims 64 and 128, causal and non-causal, S=77/T=130,
    S=64/T=256 and S=200/T=333 (off the tile sizes, S != T), S=T=192, one
    query row (S=1/T=64) and one key (S=130/T=1); in bf16 also q, k, v as
    strided views of packed qkv tensors (S=200/T=333 and S=1/T=64); then
    the timing shape."""
    rng = np.random.default_rng(4)
    cases = []
    grid = [(Kd, dtype, S, T, causal, False)
            for Kd in (64, 128) for dtype in (torch.float32, torch.bfloat16)
            for S, T in ((77, 130), (64, 256), (200, 333), (192, 192),
                         (1, 64), (130, 1))
            for causal in (True, False)]
    grid += [(Kd, torch.bfloat16, S, T, causal, True) for Kd in (64, 128)
             for S, T in ((200, 333), (1, 64)) for causal in (True, False)]
    for Kd, dtype, S, T, causal, packed in grid:
        dn = str(dtype).split(".")[1]
        tag = (f"B=2 S={S} T={T} H=3 K={Kd} {dn} "
               f"{'causal' if causal else 'full'}"
               f"{' packed qkv views' if packed else ''}")
        res = check_flash(rng, tag, 2, S, T, 3, Kd, dtype, causal, device,
                          packed)
        for kern, r in res.items():
            errs[kern] = max(errs[kern], r["max_abs_err"])
            cases.append({"kernel": kern, "case": tag, **r})
    emit({"phase": "flash_kernels_vs_plain", "tolerance": FLASH_TOLERANCE,
          "cases": cases})
    return time_flash(device, errs)


def time_flash(device, errs):
    """Each flash kernel at the training step's shape, [8, 1024, 12, 64]
    bf16 causal: held once more to its plain version on these inputs,
    then timed (`device_ms`, CUDA events beside it) beside its bound, its
    plain version and SDPA (forward alone; forward plus backward)."""
    B, S, Hh, Kd = FLASH_SHAPE
    dt, item = torch.bfloat16, 2
    scale = 1.0 / np.sqrt(Kd)
    res = check_flash(np.random.default_rng(5), "training shape", B, S, S,
                      Hh, Kd, dt, True, device)
    for kern, r in res.items():
        errs[kern] = max(errs[kern], r["max_abs_err"])
    q, k, v, do, dlse = flash_inputs(np.random.default_rng(5), B, S, S, Hh,
                                     Kd, dt, device)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(o, do)
    planted = planted_flash_faults(q, k, v, do, lse, delta, scale)
    n = B * S * Hh * Kd                      # elements of one operand
    rowvec = B * S * Hh * 4                  # one fp32 row vector
    pairs = B * Hh * S * (S + 1) // 2        # visible (row, key) pairs
    timings = {}
    plan = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True, scale),
                      lambda: fa.reference_flash_fwd(q, k, v, True, scale),
                      4 * n * item + rowvec, 2 * 2 * Kd * pairs),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, True,
                                         scale),
                     lambda: fa.reference_flash_dq(q, k, v, do, lse, delta,
                                                   True, scale),
                     5 * n * item + 2 * rowvec, 3 * 2 * Kd * pairs),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, True,
                                           scale),
                      lambda: fa.reference_flash_dkv(q, k, v, do, lse, delta,
                                                     True, scale),
                      6 * n * item + 2 * rowvec, 4 * 2 * Kd * pairs),
    }
    for name, (kern, plain, nbytes, flops) in plan.items():
        ms, ms_events = kernel_ms(kern)
        plain_ms = cuda_time_ms(plain, iters=5, warmup=1)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        timings[name] = dict(ms=ms, ms_events=ms_events, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, bytes=nbytes,
                             flops=flops, check=res[name],
                             shape=f"B={B} S=T={S} H={Hh} K={Kd} bf16 causal")
    # SDPA on [B, H, S, K] copies: a yardstick, never called by the port.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    with torch.no_grad():
        sdpa_fwd, sdpa_fwd_events = kernel_ms(sdpa)
    timings["flash_fwd"]["library_ms"] = sdpa_fwd
    timings["flash_fwd"]["library_ms_events"] = sdpa_fwd_events
    # The pair's yardstick: one PyTorch call that computes dq, dk and dv
    # (and its own delta) from the forward's out and lse. Two routes,
    # each held once to the plain versions: aten's flash backward called
    # alone, and the backward of SDPA's own graph (whichever backend SDPA
    # picks); the faster is the library time.
    refs = (fa.reference_flash_dq(q, k, v, do, lse, delta, True, scale),
            *fa.reference_flash_dkv(q, k, v, do, lse, delta, True, scale))
    aten_bwd, aten_check = aten_flash_backward(qt, kt, vt, dot, scale, refs)
    aten_ms, aten_events = kernel_ms(aten_bwd)
    sdpa_bwd, sdpa_check = sdpa_backward(qt, kt, vt, dot, scale, refs)
    sdpa_bwd_ms, sdpa_bwd_events = kernel_ms(sdpa_bwd)
    sdpa_bwd_kernels = kernel_names(sdpa_bwd)
    lib_bwd_ms, lib_bwd_events, lib_call = min(
        (aten_ms, aten_events, "aten_flash_backward"),
        (sdpa_bwd_ms, sdpa_bwd_events, "sdpa_autograd_backward"))
    delta_ms, delta_events = kernel_ms(lambda: fa.flash_delta(o, do))
    # The call does the work of flash_delta, flash_dq and flash_dkv
    # together, so its time stands on one row, beside theirs summed.
    timings["flash_dq"].update(
        library_ms=lib_bwd_ms, library_ms_events=lib_bwd_events,
        library_call=lib_call, library_covers=list(BWD_PAIR),
        covered_ms=delta_ms + timings["flash_dq"]["ms"]
        + timings["flash_dkv"]["ms"])
    timings["flash_dkv"].update(library_ms=None, library_see="flash_dq")
    for name in BWD_PAIR[1:]:
        timings[name].update(delta_ms=delta_ms, delta_ms_events=delta_events)
    # Forward plus backward launches several kernels from the host (SDPA's
    # through autograd), so their gaps depend on the host's speed: compare
    # the device time of their kernels instead.
    sdpa_fwd_bwd = device_ms(
        lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    ours = device_ms(lambda: fa.flash_bwd(
        q, k, v, *fa.flash_fwd(q, k, v, True, scale), do, None, True, scale))
    fa.reset_launch_counts()
    emit({"phase": "flash_kernel_timing", **timings,
          "planted_faults_vs_bf16_bound": planted,
          "fwd_dq_dkv_device_ms": ours, "sdpa_fwd_ms": sdpa_fwd,
          "sdpa_fwd_bwd_device_ms": sdpa_fwd_bwd,
          "aten_flash_backward_ms": aten_ms,
          "aten_flash_backward_vs_plain": aten_check,
          "sdpa_backward_ms": sdpa_bwd_ms,
          "sdpa_backward_vs_plain": sdpa_check,
          "sdpa_backward_kernels": sdpa_bwd_kernels,
          "flash_delta_ms": delta_ms,
          "note": "fwd_dq_dkv_device_ms: the kernels of flash_fwd, delta, "
                  "flash_dq and flash_dkv, against those of SDPA (is_causal)"
                  " forward plus backward; sdpa_backward_ms: the backward "
                  "of SDPA's graph alone (autograd.grad, retain_graph); "
                  "aten_flash_backward_ms: aten's _scaled_dot_product_flash"
                  "_attention_backward alone; the faster is flash_dq's "
                  "library_ms, which covers flash_delta, flash_dq and "
                  "flash_dkv (covered_ms: their times summed), and "
                  "flash_dkv's library_ms is null; flash_delta_ms: the "
                  "port's delta (torch ops) alone; device time per call "
                  "(device_ms)"})
    return timings


ATEN_BWD_REL = 2e-2   # the library backward against the plain versions
# The port's backward kernels, which one library call does together.
BWD_PAIR = ("flash_delta", "flash_dq", "flash_dkv")


def hold_to_plain(label, grads, refs):
    """The relative error of each whole gradient (dq, dk, dv as
    [B, H, S, K]) against the plain versions ``refs`` ([B, S, H, K]);
    raises past ATEN_BWD_REL."""
    check = {}
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        ref = ref.float()
        rel = float((g.transpose(1, 2).float() - ref).norm() / ref.norm())
        check[name] = rel
        if not rel <= ATEN_BWD_REL:
            raise AssertionError(f"{label} {name} is {rel} off the plain "
                                 "version")
    return check


def sdpa_backward(qt, kt, vt, dot, scale, refs):
    """The backward of SDPA's own graph (is_causal, the same scale) on
    [B, H, S, K] copies, whichever backend SDPA picks: the forward runs
    once, and the call is torch.autograd.grad over its graph, kept for
    every call. A yardstick only, held once to the plain versions like
    `aten_flash_backward`. → (the call, the check's numbers)."""
    qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         scale=scale)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return call, hold_to_plain("SDPA backward", call(), refs)


def kernel_names(fn):
    """The names of the device kernels one call of fn launches (read
    from torch.profiler; names only, no times)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:100] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def aten_flash_backward(qt, kt, vt, dot, scale, refs):
    """aten's flash backward (``_scaled_dot_product_flash_attention_
    backward``) on [B, H, S, K] copies, with out, lse and the philox
    arguments of aten's causal flash forward at the same scale: a
    yardstick only, the port never calls it. Its dq, dk and dv are held
    once, loosely, to the plain versions ``refs`` ([B, S, H, K]: the
    relative error of each whole gradient <= ATEN_BWD_REL) so that the
    yardstick is known to compute the same function. → (the call, the
    check's numbers)."""
    qt, kt, vt = (x.detach() for x in (qt, kt, vt))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]

    def call():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True,
            seed, offset, scale=scale)

    return call, hold_to_plain("aten flash backward", call(), refs)


def old_library(old_dir):
    """The kernels of an older checkout (``old_dir``/ray_tpu_torch/ops/
    csrc) built by nvcc into build/ab/libkernels_old.so, one nvcc per
    source in parallel, with the C ABI of the parent of the decode's
    redesign: the flash kernels and the paged prefill as now (tensor maps
    passed by the caller), the paged decode without workspace or split
    count."""
    src = os.path.join(old_dir, "ray_tpu_torch", "ops", "csrc")
    out = os.path.join("build", "ab")
    os.makedirs(out, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for name in sorted(os.listdir(src)):
        if name.endswith(".cu"):
            objs.append(os.path.join(out, name[:-3] + ".o"))
            procs.append(subprocess.Popen(
                [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-c",
                 os.path.join(src, name), "-o", objs[-1]]))
    if any(p.wait() for p in procs):
        raise RuntimeError(f"nvcc failed on {src}")
    lib_path = os.path.join(out, "libkernels_old.so")
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", lib_path,
                    *objs], check=True)
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    _build._declare(lib)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtt_paged_decode_attention.argtypes = [I] + [P] * 6 + [I] * 5 + [
        Fl, P]
    lib.rtt_paged_decode_attention_int8.argtypes = [I] + [P] * 8 + [
        I] * 5 + [Fl, P]
    return lib


def old_decode(old, q, kp, vp, tables, lengths, sc):
    """The parent's decode wrapper on its library: the same checks, one
    launch of grid (H, B), no workspace (as `paged_attention` was before
    the split-K redesign, without its counters)."""
    quant = pa._quantized(kp, vp, sc.get("k_scale"), sc.get("v_scale"))
    B, Hh, Kd = q.shape
    ps = pa._check_shapes(q, kp, vp, Hh, Kd)
    tables, lengths = pa._cuda_operands(
        q, kp, vp, (("tables", tables), ("lengths", lengths)), quant)
    out = torch.empty_like(q)
    common = (tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, Hh,
              Kd, ps, tables.shape[1], float(1 / np.sqrt(Kd)),
              torch.cuda.current_stream().cuda_stream)
    code = pa._DTYPE_CODES[q.dtype]
    if quant:
        ks, vs = pa._scale_operands(q.device, sc["k_scale"], sc["v_scale"])
        rc = old.rtt_paged_decode_attention_int8(
            code, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), *common)
    else:
        rc = old.rtt_paged_decode_attention(
            code, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *common)
    _build.check(rc, "old decode")
    return out


def phase_ab(device, old_dir):
    """The kernels against an older checkout's, at the timed shapes, by
    device time in turns (old, new, new, old) in one process: the bf16
    flash forward, dq and dkv at [8, 1024, 12, 64] causal, the paged
    prefill (16 slots x C 256 at offset 768, 1024-token contexts, ps 64,
    H 32, K 64) and the paged decode (16 slots of 1024 positions, and at
    light load) on a bf16 and on an int8 pool; for the decode also the
    wrapper's host µs per call, the parent's wrapper (`old_decode`)
    against the new one. Each old output is held to the new one's plain
    version first (dq, dkv and the decode: the bf16 bound must hold)."""
    old = old_library(old_dir)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    B, S, Hh, Kd = FLASH_SHAPE
    q, k, v, do, _dl = flash_inputs(rng, B, S, S, Hh, Kd, torch.bfloat16,
                                    device)
    scale = 1.0 / np.sqrt(Kd)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(o, do)

    def flash_old():
        o = torch.empty_like(q)
        lse = torch.empty(B, S, Hh, device=device, dtype=torch.float32)
        rows = fa._rows(q, k, v, o)
        maps = pa._c_array(fa.flash_plan(q, k, v))
        _build.check(old.rtt_flash_fwd(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, S, Hh, Kd, ctypes.addressof(rows), 1,
            float(scale), ctypes.addressof(maps), stream()), "old flash_fwd")
        return o

    def dq_old():
        dq = torch.empty_like(q)
        rows = fa._rows(q, k, v, do, dq)
        maps = pa._c_array(fa.flash_dq_plan(q, k, v, do))
        _build.check(old.rtt_flash_dq(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, S, Hh, Kd,
            ctypes.addressof(rows), 1, float(scale), ctypes.addressof(maps),
            stream()), "old flash_dq")
        return dq

    def dkv_old():
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rows = fa._rows(q, k, v, do, dk, dv)
        maps = pa._c_array(fa.flash_dkv_plan(q, k, v, do))
        _build.check(old.rtt_flash_dkv(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, S, Hh, Kd, ctypes.addressof(rows), 1, float(scale),
            ctypes.addressof(maps), stream()), "old flash_dkv")
        return dk, dv

    bwd = (q, k, v, do, lse, delta, True, scale)
    cases = {
        "flash_fwd": (flash_old, lambda: fa.flash_fwd(q, k, v, True, scale)[0],
                      lambda: fa.reference_flash_fwd(q, k, v, True, scale)[0]),
        "flash_dq": (dq_old, lambda: fa.flash_dq(*bwd),
                     lambda: fa.reference_flash_dq(*bwd)),
        "flash_dkv": (dkv_old, lambda: fa.flash_dkv(*bwd),
                      lambda: fa.reference_flash_dkv(*bwd)),
    }
    sums = flash_abs_sums(*bwd)
    bound_sums = {"flash_dq": sums["flash_dq"],
                  "flash_dkv": torch.stack((sums["flash_dk"],
                                            sums["flash_dv"]))}
    T, C, ps = 1024, 256, 64
    n_pg = T // ps
    for quant in (False, True):
        kp, vp, tables, lens, sc = paged_pool(
            rng, [T] * 16, ps=ps, n_pg=n_pg, dtype=torch.bfloat16,
            device=device, quant=quant)
        qp = torch.from_numpy(rng.normal(size=(16, C, H, K)).astype(
            np.float32)).to(device, torch.bfloat16)
        args = [torch.from_numpy(a).to(device) for a in (
            tables, np.full(16, T - C, np.int32), lens)]

        def prefill_old(qp=qp, kp=kp, vp=vp, args=args, sc=sc):
            out = torch.empty_like(qp)
            ptrs = [qp.data_ptr(), kp.data_ptr(), vp.data_ptr()]
            if sc:
                ptrs += [sc["k_scale"].data_ptr(), sc["v_scale"].data_ptr()]
            fn = (old.rtt_paged_prefill_attention_int8 if sc
                  else old.rtt_paged_prefill_attention)
            maps = pa._c_array(pa.prefill_plan(qp, kp, vp))
            _build.check(fn(1, *ptrs, *(a.data_ptr() for a in args),
                            out.data_ptr(), 16, C, H, K, ps, n_pg,
                            float(1 / np.sqrt(K)), ctypes.addressof(maps),
                            stream()), "old prefill")
            return out

        name = "paged_prefill_attention" + ("_int8" if quant else "")
        cases[name] = (
            prefill_old,
            lambda qp=qp, kp=kp, vp=vp, args=args, sc=sc:
                pa.paged_prefill_attention(qp, kp, vp, *args, **sc),
            lambda qp=qp, kp=kp, vp=vp, args=args, sc=sc:
                pa.reference_paged_prefill_attention(qp, kp, vp, *args,
                                                     **sc))
    # The paged decode, float and int8 pools, at the timed shape (16 slots
    # of 1024 positions) and at light load (`light_load_case`).
    for quant in (False, True):
        kp, vp, tables, lens, sc = paged_pool(
            rng, [T] * 16, ps=ps, n_pg=n_pg, dtype=torch.bfloat16,
            device=device, heads=(H, K), quant=quant)
        qd = torch.from_numpy(rng.normal(size=(16, H, K)).astype(
            np.float32)).to(device, torch.bfloat16)
        timed = (qd, kp, vp, *(torch.from_numpy(a).to(device)
                               for a in (tables, lens)), sc)
        light = light_load_case(rng, device, quant=quant)[:6]
        for shape, (qd, kp, vp, tb, ln, sc) in (("", timed),
                                                 ("_light_load", light)):
            name = "paged_attention" + ("_int8" if quant else "") + shape
            cases[name] = (
                lambda a=(qd, kp, vp, tb, ln, sc): old_decode(old, *a),
                lambda a=(qd, kp, vp, tb, ln), sc=sc: pa.paged_attention(
                    *a, **sc),
                lambda a=(qd, kp, vp, tb, ln), sc=sc:
                    pa.reference_paged_attention(*a, **sc))
            bound_sums[name] = abs_v_attention(
                pa.reference_paged_attention, qd, kp, vp, tb, ln, **sc)
    out = {"phase": "ab_old_vs_new", "old": old_dir,
           "order": "old, new, new, old; device ms per call (device_ms); "
                    "decode also the wrapper's host µs per call"}
    # dkv's (dk, dv) are held as one tensor; the timed calls stack nothing.
    one = lambda x: (torch.stack(x) if isinstance(x, tuple) else x).float()
    for name, (fn_old, fn_new, plain) in cases.items():
        ref = one(plain())
        outs = {"old": one(fn_old()), "new": one(fn_new())}
        err = {tag: float((x - ref).abs().max()) for tag, x in outs.items()}
        res = {"max_abs_err_vs_plain": err}
        if name in bound_sums:
            share = {tag: float(share_of_bound(x, ref, bound_sums[name]))
                     for tag, x in outs.items()}
            res["max_share_of_bf16_bound"] = share
            if max(share.values()) > 1.0:
                raise AssertionError(f"A/B {name} off its plain version: "
                                     f"{share}")
        turns = [device_ms(f) for f in (fn_old, fn_new, fn_new, fn_old)]
        out[name] = {"old_ms": [turns[0], turns[3]],
                     "new_ms": [turns[1], turns[2]],
                     "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2]),
                     **res}
        if name.startswith("paged_attention"):
            us = [host_us(f) for f in (fn_old, fn_new, fn_new, fn_old)]
            out[name]["host_us"] = {"old": [us[0], us[3]],
                                    "new": [us[1], us[2]]}
    emit(out)


def make_params(device):
    """opt_1_3b's fp32 masters from seed 0 and their bf16 serving copy:
    the int8 runs quantize the same masters."""
    cfg = gpt.GPTConfig.opt_1_3b(dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    masters = gpt.init_params(cfg, gen, device)
    return cfg, masters, pk.serving_params(cfg, masters, device)


def run_programs(device, cfg, params, pool, impl):
    """One prefill_chunk_paged dispatch (rows: 256 tokens at offset 0,
    200 at 256, 17 at 0, an inert row) then one decode_step_paged on a
    copy of ``pool`` → the live rows' fp32 logits of each."""
    rng = np.random.default_rng(2)
    ps, width = pool["k"].shape[2], 8
    tables = np.zeros((4, width), np.int32)
    tables[:3] = np.arange(1, 3 * width + 1).reshape(3, width)
    offsets = np.array([0, 256, 0, 0], np.int32)
    n_valid = np.array([256, 200, 17, 0], np.int32)
    toks = rng.integers(1, cfg.vocab_size, size=(4, 256)).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).to(device)
    p = {k: v.clone() for k, v in pool.items()}
    lg, _ = pk.prefill_chunk_paged(cfg, params, dev(toks), p, dev(tables),
                                   dev(offsets), dev(n_valid), attn_impl=impl)
    lg2, _ = pk.decode_step_paged(
        cfg, params, dev(toks[:, 0].copy()), p,
        dev((offsets + n_valid).astype(np.int32)), dev(tables),
        attn_impl=impl)
    torch.cuda.synchronize()
    return lg[:3].float(), lg2[:3].float()


PROGRAM_NAMES = ("prefill_chunk_paged", "decode_step_paged")


def logit_diff(a, b, vocab):
    if not (torch.isfinite(a).all() and a.shape == (3, vocab)):
        raise AssertionError(f"bad logits {tuple(a.shape)}")
    return {"logit_mae": float((a - b).abs().mean()),
            "logit_max_abs": float((a - b).abs().max()),
            "logit_mean_abs": float(b.abs().mean()),
            "argmax_equal": int((a.argmax(-1) == b.argmax(-1)).sum())}


def phase_programs(device, cfg, params):
    pool = pk.init_paged_kv(cfg, 32, 64, device=device)
    logits = {impl: run_programs(device, cfg, params, pool, impl)
              for impl in ("kernel", "gather")}
    out = {"phase": "programs", "config": "opt_1_3b bf16 24 layers",
           "mae_bound": PROGRAM_LOGIT_MAE}
    for i, name in enumerate(PROGRAM_NAMES):
        out[name] = logit_diff(logits["kernel"][i], logits["gather"][i],
                               cfg.vocab_size)
        if out[name]["logit_mae"] > PROGRAM_LOGIT_MAE:
            raise AssertionError(f"{name}: kernel vs gather logit MAE "
                                 f"{out[name]['logit_mae']} > "
                                 f"{PROGRAM_LOGIT_MAE}")
    emit(out)


def first_page_nulled(fn):
    """A planted fault in a paged-attention wrapper: every slot's first
    page read from the null page instead (in every layer)."""
    def wrong(q, k_pool, v_pool, tables, *args, **kw):
        tables = tables.clone()
        tables[:, 0] = 0
        return fn(q, k_pool, v_pool, tables, *args, **kw)
    return wrong


def phase_programs_int8(device, cfg, masters, served):
    """The int8 programs at full width: int8 weights quantized from the
    masters, copies of one int8 pool, "kernel" against "gather", held to
    PROGRAM_INT8_LOGIT_MAE, which a planted fault (each slot's first page
    read from the null page, in every layer) must exceed; then, as a
    fidelity reading with no limit, int8 weights against the bf16 weights
    of the same masters (both on the int8 pool, kernel path)."""
    w8 = pk.serving_params(cfg, gpt.quantize_params(masters), device)
    pool = pk.init_paged_kv(cfg, 32, 64, kv_dtype="int8", device=device)
    logits = {impl: run_programs(device, cfg, w8, pool, impl)
              for impl in ("kernel", "gather")}
    real = pk.paged_attention, pk.paged_prefill_attention
    pk.paged_attention, pk.paged_prefill_attention = map(first_page_nulled,
                                                         real)
    try:
        faulty = run_programs(device, cfg, w8, pool, "kernel")
    finally:
        pk.paged_attention, pk.paged_prefill_attention = real
    bf16_w = run_programs(device, cfg, served, pool, "kernel")
    out = {"phase": "programs_int8",
           "config": "opt_1_3b bf16 24 layers, int8 weights, int8 KV",
           "mae_bound": PROGRAM_INT8_LOGIT_MAE,
           "planted_fault": "each slot's first page read from the null page"}
    for i, name in enumerate(PROGRAM_NAMES):
        ref = logits["gather"][i]
        out[name] = {
            **logit_diff(logits["kernel"][i], ref, cfg.vocab_size),
            "planted_fault_logit_mae": logit_diff(
                faulty[i], ref, cfg.vocab_size)["logit_mae"],
            "int8_vs_bf16_weights": logit_diff(logits["kernel"][i],
                                               bf16_w[i], cfg.vocab_size)}
        if out[name]["logit_mae"] > PROGRAM_INT8_LOGIT_MAE:
            raise AssertionError(f"{name}: int8 kernel vs gather logit MAE "
                                 f"{out[name]['logit_mae']} > "
                                 f"{PROGRAM_INT8_LOGIT_MAE}")
        if out[name]["planted_fault_logit_mae"] <= PROGRAM_INT8_LOGIT_MAE:
            raise AssertionError(f"{name}: the planted fault passes: {out}")
    emit(out)
    del w8
    torch.cuda.empty_cache()


KERNEL_CATEGORIES = (       # first match wins, on the lower-cased name
    ("port kernels", ("rtt::",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("copy / cast", ("copy",)),
    ("reduction / softmax / loss", ("reduce", "softmax", "nll", "norm")),
    ("index / scatter", ("index", "scatter", "gather", "embedding")),
    ("elementwise", ("elementwise",)),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for cat, keys in KERNEL_CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _profiled(fn, top=8):
    """Run fn once without and once under torch.profiler: wall time of
    the plain run (host clock around a synchronized run), the summed time
    of the device's kernels in the profiled one, the device's idle share
    of the plain wall time, and the top kernels by device time and ops by
    host self time. Only kernel events count toward device time: an aten
    op's own device time is that of its kernels, which would count them
    twice."""
    fn()                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_us = sum(dev_us(e) for e in kernels)
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]

    def table(events, ms):
        # Names are cut to 80 characters; events whose cut names collide
        # (template instances of one kernel) are summed.
        out: dict = {}
        for e in events:
            out[e.key[:80]] = out.get(e.key[:80], 0.0) + ms(e)
        return out

    by_cat: dict = {}
    for e in kernels:
        cat = kernel_category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us(e) / 1e3
    return {
        "wall_ms": wall_plain * 1e3,
        "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_ms_by_category": by_cat,
        "device_idle_share": (1.0 - busy_us / 1e3 / (wall_plain * 1e3)
                              if busy_us else None),
        "top_device_ms": table(by_dev, lambda e: dev_us(e) / 1e3),
        "top_host_ms": table(by_cpu, lambda e: e.self_cpu_time_total / 1e3),
        "host_op_calls": sum(e.count for e in ev
                             if e.key.startswith("aten::")),
    }


def phase_profile(device, cfg, masters, params):
    """Where the time goes in the engine's two dispatches at the engine
    phase's shapes: one fused decode window (k=8, 16 slots at 1024-token
    contexts) and one prefill dispatch (16 rows x 256, two live rows);
    then the decode window's device time with int8 weights (quantized
    from the same masters) against bf16 weights, on the float pool and
    with the int8 pool, and the window's K/V writes alone into each pool
    (the float pool's index_put against the int8 pool's _quant_write)."""
    B, T, ps = 16, 1024, 64
    n_pg = T // ps
    pool = pk.init_paged_kv(cfg, B * n_pg, ps, device=device)
    tables = torch.arange(1, B * n_pg + 1, dtype=torch.int32,
                          device=device).reshape(B, n_pg)
    toks = torch.ones(B, dtype=torch.int32, device=device)
    pos = torch.full((B,), T - 16, dtype=torch.int32, device=device)
    temps = torch.zeros(B, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def window(weights, kv):
        return lambda: pk.decode_multi_paged(
            cfg, weights, toks, kv, pos, tables, 8, temps, gen,
            attn_impl="kernel")

    decode = _profiled(window(params, pool))
    decode["per_step_wall_ms"] = decode["wall_ms"] / 8
    w8 = pk.serving_params(cfg, gpt.quantize_params(masters), device)
    pool8 = pk.init_paged_kv(cfg, B * n_pg, ps, kv_dtype="int8",
                             device=device)
    gap = {"bf16 weights, bf16 KV": decode}
    gap["int8 weights, bf16 KV"] = _profiled(window(w8, pool))
    gap["int8 weights, int8 KV"] = _profiled(window(w8, pool8))
    gap["bf16 weights, int8 KV"] = _profiled(window(params, pool8))
    weight_gap = {arm: {k: r[k] for k in ("device_busy_ms", "wall_ms",
                                          "host_op_calls",
                                          "device_ms_by_category")}
                  for arm, r in gap.items()}
    # The window's K/V writes alone (8 steps x n_layers, both sides), into
    # each pool: what _quant_write adds to the int8-KV window on the host.
    rows = torch.randn(B, cfg.n_heads, cfg.head_dim, device=device,
                       dtype=cfg.dtype)
    wpage = tables[:, (T - 16) // ps].long()
    woff = torch.full((B,), (T - 16) % ps, dtype=torch.int64, device=device)

    def writes(kv):
        def run():
            for _ in range(8):
                for l in range(cfg.n_layers):
                    pk._write_rows(kv, l, wpage, woff, rows, rows, cfg.dtype,
                                   "k_scale" in kv)
        return run
    kv_writes = {arm: {k: r[k] for k in ("wall_ms", "device_busy_ms",
                                         "host_op_calls")}
                 for arm, r in (("bf16 KV", _profiled(writes(pool))),
                                ("int8 KV", _profiled(writes(pool8))))}
    del w8, pool8
    torch.cuda.empty_cache()
    ptoks = torch.ones(B, 256, dtype=torch.int32, device=device)
    offs = torch.zeros(B, dtype=torch.int32, device=device)
    nv = torch.from_numpy(np.array([256, 256] + [0] * (B - 2),
                                   np.int32)).to(device)
    prefill = _profiled(lambda: pk.prefill_chunk_paged(
        cfg, params, ptoks, pool, tables[:, :4].contiguous(), offs, nv,
        attn_impl="kernel"))
    emit({"phase": "profile", "decode_window_k8": decode,
          "prefill_dispatch_16x256": prefill,
          "decode_window_k8_device_ms_by_weights_and_kv": weight_gap,
          "decode_window_k8_kv_writes_alone": kv_writes})


ENGINE_PROMPT_SEED, ENGINE_TOKENS = 3, 32


def engine_prompts(cfg):
    rng = np.random.default_rng(ENGINE_PROMPT_SEED)
    lengths = rng.integers(128, 1537, size=16)
    return [list(map(int, rng.integers(1, cfg.vocab_size, n)))
            for n in lengths]


def run_engine(device, cfg, params, **knobs):
    """LLMEngine(opt_1_3b) serving the 16 seeded prompts through
    start()/submit(), 32 greedy tokens each, with every paged launch
    counter zeroed just before and read just after. → (engine, requests,
    launches, wall seconds); raises on a request error, a bad output or
    page accounting that does not close."""
    eng = LLMEngine(cfg, params, n_slots=16, max_len=2048, page_size=64,
                    prefill_chunk=256, prefill_token_budget=512,
                    attn_impl="kernel", device=device, **knobs)
    prompts = engine_prompts(cfg)
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    eng.start()
    try:
        reqs = [eng.submit(p, max_tokens=ENGINE_TOKENS) for p in prompts]
        for r in reqs:
            if not r.done.wait(timeout=600):
                raise AssertionError("engine request timed out")
    finally:
        eng.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_prefill_attention": pa.paged_prefill_attention.launches,
                "paged_attention_int8": pa.paged_attention.int8_launches,
                "paged_prefill_attention_int8":
                    pa.paged_prefill_attention.int8_launches}
    errors = [r.error for r in reqs if r.error is not None]
    if errors:
        raise AssertionError(f"engine request errors: {errors[:3]}")
    for r in reqs:
        if len(r.out_ids) != ENGINE_TOKENS or r.truncated or not all(
                0 <= t < cfg.vocab_size for t in r.out_ids):
            raise AssertionError(f"bad output for {r.request_id}: "
                                 f"{len(r.out_ids)} tokens")
    acc = eng.page_accounting()
    if not (acc["closure"] and acc["refs_consistent"]
            and acc["free"] == acc["total"]):
        raise AssertionError(f"page accounting open: {acc}")
    return eng, reqs, launches, wall


def engine_record(cfg, eng, reqs, launches, wall, decode, prefill):
    """The phase's JSON line: counts, launches per step and per dispatch
    of the programs ``decode`` and ``prefill`` ran, and the end-to-end
    metrics."""
    m = eng.metrics()
    steps, dispatches = m["decode_steps"], m["prefill_dispatches"]
    return {"requests": len(reqs),
            "prompt_tokens": sum(len(r.prompt_ids) for r in reqs),
            "wall_s": wall, "launches": launches,
            "decode_steps": steps, "decode_windows": m["decode_windows"],
            "decode_launches_per_step": launches[decode] / max(1, steps),
            "decode_launches_per_window": (
                launches[decode] / max(1, m["decode_windows"])),
            "prefill_dispatches": dispatches,
            "prefill_launches_per_dispatch": (
                launches[prefill] / max(1, dispatches)),
            **{k: m.get(k) for k in (
                "engine_decode_tok_s", "engine_prefill_tok_s", "ttft_ms_p50",
                "ttft_ms_p95", "decode_step_ms_p50", "decode_step_ms_p95",
                "preemptions", "kv_pages_free_min", "kv_pool_bytes",
                "llm_weight_dtype", "llm_kv_dtype")},
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in eng.params.values()),
            "page_accounting": eng.page_accounting()}


def phase_engine(device, cfg, params):
    """The float engine (bf16 weights and KV) on the float programs."""
    eng, reqs, launches, wall = run_engine(device, cfg, params)
    if min(launches["paged_attention"],
           launches["paged_prefill_attention"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if launches["paged_attention_int8"] or launches[
            "paged_prefill_attention_int8"]:
        raise AssertionError(f"an int8 program ran in the float engine: "
                             f"{launches}")
    out = engine_record(cfg, eng, reqs, launches, wall, "paged_attention",
                        "paged_prefill_attention")
    emit({"phase": "engine", "config": "opt_1_3b bf16", **out})
    return launches, out, [r.out_ids for r in reqs]


def agreement(streams, ref):
    """Per request, the share of its tokens before the first one that
    differs from the reference stream's."""
    shares = []
    for a, b in zip(streams, ref):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        shares.append(n / len(a))
    return shares


def phase_engine_int8(device, cfg, masters, float_run, float_streams):
    """The same traffic on LLMEngine(opt_1_3b, weight_dtype="int8",
    kv_dtype="int8") from the fp32 masters (quantized at load): exactly
    n_layers int8 launches per decode step and per prefill dispatch, no
    float paged launch, and kv_pool_bytes = the bf16 engine's / 2 plus
    the two bf16 [L, P+1] scale planes."""
    eng, reqs, launches, wall = run_engine(device, cfg, masters,
                                           weight_dtype="int8",
                                           kv_dtype="int8")
    out = engine_record(cfg, eng, reqs, launches, wall,
                        "paged_attention_int8", "paged_prefill_attention_int8")
    L = cfg.n_layers
    if launches["paged_attention"] or launches["paged_prefill_attention"]:
        raise AssertionError(f"a float program ran in the int8 engine: "
                             f"{launches}")
    if (launches["paged_attention_int8"] != L * out["decode_steps"]
            or launches["paged_prefill_attention_int8"]
            != L * out["prefill_dispatches"] or not out["decode_steps"]):
        raise AssertionError(f"int8 launches {launches} are not {L} per "
                             f"decode step and per prefill dispatch: {out}")
    scale_planes = 2 * L * (eng.n_pages + 1) * 2
    expect = float_run["kv_pool_bytes"] // 2 + scale_planes
    if out["kv_pool_bytes"] != expect:
        raise AssertionError(f"kv_pool_bytes {out['kv_pool_bytes']} != "
                             f"{expect} (bf16 engine's / 2 + scale planes)")
    shares = agreement([r.out_ids for r in reqs], float_streams)
    emit({"phase": "engine_int8", "config": "opt_1_3b bf16, int8 weights "
          "(from the fp32 masters), int8 KV", **out,
          "kv_pool_bytes_expected": expect,
          "weight_bytes_bf16_engine": float_run["weight_bytes"],
          "agreement_with_bf16_engine": {
              "share_before_first_divergence": shares,
              "mean": float(np.mean(shares)),
              "identical_streams": sum(x == 1.0 for x in shares)}})
    return launches


# ------------------------------------------------------------------- train

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 12
# Launches per step with remat: the forward runs once per block and once
# more in the block's recompute; dq and dkv once per block.
FLASH_PER_STEP = {"flash_fwd": 24, "flash_dq": 12, "flash_dkv": 12}
# flash vs xla, one step from the same parameters and batch, bf16: the two
# attention paths round probabilities at different places (unit roundoff
# 2^-8) and the difference goes through 12 bf16 layers. The loss is a mean
# over 8192 tokens; the gradient is held as a whole and, since the
# embedding and head dominate its norm, on the attention weights of each
# layer alone, where a wrong attention backward shows first. Each limit
# sits between the sound runs' reading and the planted faults' (the
# planted faults must exceed the attention limit in every run).
TRAIN_LOSS_TOL = 5e-4          # |loss_flash - loss_xla|
TRAIN_GRAD_TOL = 2e-2          # |g_flash - g_xla| / |g_xla|, all leaves
TRAIN_ATTN_GRAD_TOL = 5e-2     # the same, worst (layer, wq/wk/wv/wo) slice
ATTN_LEAVES = ("wq", "wk", "wv", "wo")


def train_flops_per_token(cfg) -> float:
    """bench.py's count: ~6N per token (forward 2N, backward 4N) with N
    the matmul parameters (tied embedding/unembedding, 4 d^2 of attention
    and 2 d d_ff of MLP per layer), plus the attention score/value term."""
    n_params = (cfg.vocab_size * cfg.d_model
                + cfg.n_layers * (4 * cfg.d_model * cfg.d_model
                                  + 2 * cfg.d_model * cfg.d_ff))
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.max_seq
    return 6.0 * n_params + attn


def train_batch(cfg, device):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
    tg = np.roll(toks, -1, axis=1)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (toks, tg))


def loss_and_grads(cfg, params, batch, impl):
    """One step's loss and gradients ({name: grad}) with ``impl``."""
    loss = gpt.loss_fn(params, *batch,
                       dataclasses.replace(cfg, attn_impl=impl))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def step_diff(loss, grads, loss_ref, ref):
    """The step's differences from the reference step's: |Δloss|, the
    relative difference of the whole gradient, and the largest over the
    attention weights (wq, wk, wv, wo) of one layer."""
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    whole = torch.sqrt(sum((grads[n].float() - ref[n].float()).square().sum()
                           for n in ref))
    return {"loss_abs_diff": abs(loss - loss_ref),
            "grad_rel_err": float(whole / torch.sqrt(sum(
                g.float().square().sum() for g in ref.values()))),
            "attn_grad_rel_err": max(rel(grads[n][i], ref[n][i])
                                     for n in ATTN_LEAVES
                                     for i in range(ref[n].shape[0]))}


def planted_backwards(real):
    """Wrong versions of fa.flash_bwd: faults the flash-vs-xla check must
    see, from a blatant one to a dropped 64-key tile."""
    def zero_dq(*args):
        dq, dk, dv = real(*args)
        return torch.zeros_like(dq), dk, dv

    def swap_dkv(*args):
        dq, dk, dv = real(*args)
        return dq, dv, dk

    def drop_tile(q, k, v, o, lse, do, dlse, causal, scale):
        dq, dk, dv = real(q, k, v, o, lse, do, dlse, causal, scale)
        tile = dropped_tile(q, k, v, do, lse, fa.flash_delta(o, do, dlse),
                            scale, FAULT_LO)[0]
        return (dq.float() - tile).to(dq.dtype), dk, dv

    return {"dq zeroed": zero_dq, "dk and dv swapped": swap_dkv,
            f"keys {FAULT_LO}-{FAULT_LO + 63} dropped from dq": drop_tile}


def flash_vs_xla(cfg, params, batch):
    """One step with flash attention against plain attention from the
    same parameters (nothing is updated), then the same for each planted
    fault in the flash backward, each of which must fail the check."""
    loss_x, g_x = loss_and_grads(cfg, params, batch, "xla")
    loss_f, g_f = loss_and_grads(cfg, params, batch, "flash")
    res = {"loss_flash": loss_f, "loss_xla": loss_x,
           **step_diff(loss_f, g_f, loss_x, g_x),
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
           "attn_grad_tol": TRAIN_ATTN_GRAD_TOL}
    del g_f
    real, planted = fa.flash_bwd, {}
    for fault, bwd in planted_backwards(real).items():
        fa.flash_bwd = bwd
        try:
            loss_p, g_p = loss_and_grads(cfg, params, batch, "flash")
        finally:
            fa.flash_bwd = real
        planted[fault] = step_diff(loss_p, g_p, loss_x, g_x)
        del g_p
    res["planted_faults"] = planted
    if not (res["loss_abs_diff"] <= TRAIN_LOSS_TOL
            and res["grad_rel_err"] <= TRAIN_GRAD_TOL
            and res["attn_grad_rel_err"] <= TRAIN_ATTN_GRAD_TOL):
        raise AssertionError(f"flash vs xla step disagree: {res}")
    if not all(p["attn_grad_rel_err"] > TRAIN_ATTN_GRAD_TOL
               for p in planted.values()):
        raise AssertionError(f"a planted fault passes the check: {res}")
    return res


def phase_train(device):
    """bench.py's training step on the port: gpt2_124m at B=8, S=1024,
    bf16, remat, flash attention, AdamW with a bf16 first moment."""
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=TRAIN_S, remat=True,
                                  attn_impl="flash")
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state, step = build_training(cfg, opt, gen, device)
    batch = train_batch(cfg, device)
    compare = flash_vs_xla(cfg, params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()      # the peak of the steps alone

    fa.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(1 + TRAIN_STEPS):          # one warm-up step
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))            # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_dq": fa.flash_dq.launches,
                "flash_dkv": fa.flash_dkv.launches}
    steps = 1 + TRAIN_STEPS
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != FLASH_PER_STEP:
        raise AssertionError(f"flash launches per step {per_step}, "
                             f"expected {FLASH_PER_STEP}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    timed = step_ms[1:]
    p50 = float(np.median(timed))
    tok_s = TRAIN_B * TRAIN_S / (p50 / 1e3)
    peak_mem = torch.cuda.max_memory_allocated()
    profiled = _profiled(lambda: step(params, opt_state, batch), top=12)
    out = {"phase": "train", "config": "gpt2_124m bf16 remat flash "
           f"B={TRAIN_B} S={TRAIN_S} adamw(3e-4, wd=0.1, mu bf16)",
           "params": gpt.num_params(cfg), "flash_vs_xla": compare,
           "steps_timed": TRAIN_STEPS, "step_ms": step_ms,
           "step_ms_p50": p50, "tokens_per_s": tok_s,
           "mfu": train_flops_per_token(cfg) * tok_s / BF16_FLOPS,
           "flops_per_token": train_flops_per_token(cfg),
           "max_memory_allocated_gb": peak_mem / 2**30,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": launches,
           "launches_per_step": per_step, "profile_one_step": profiled}
    emit(out)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases: kernels,programs,profile,"
                         "engine,train (default: all; the build always "
                         "runs)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills)")
    ap.add_argument("--ab", metavar="OLD_CHECKOUT", default="",
                    help="also time the flash forward, dq, dkv and paged "
                         "prefill and decode kernels against an older "
                         "checkout's (its ray_tpu_torch/ops/csrc, built "
                         "into build/ab), in turns old, new, new, old")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    only = set(filter(None, args.only.split(",")))
    want = lambda p: not only or p in only
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.build(verbose=args.ptxas)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(p.relative_to(_build.REPO_ROOT))
                      for p in _build.sources()],
          "arch": "sm_90a", "sass_ops": sass_ops(_build.LIB_PATH)})

    meta = {
        "paged_attention": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                            "ray_tpu/ops/paged_attention.py:55"),
        "paged_prefill_attention": ("ray_tpu_torch/ops/csrc/paged_prefill.cu",
                                    "ray_tpu/ops/paged_attention.py:206"),
        "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                      "ray_tpu/ops/attention.py:67"),
        "flash_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                     "ray_tpu/ops/attention.py:182"),
        "flash_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                      "ray_tpu/ops/attention.py:224"),
        # The int8 programs of the two paged kernels (quantized=True there).
        "paged_attention_int8": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                                 "ray_tpu/ops/paged_attention.py:55"),
        "paged_prefill_attention_int8": (
            "ray_tpu_torch/ops/csrc/paged_prefill.cu",
            "ray_tpu/ops/paged_attention.py:206"),
    }
    errs = dict.fromkeys(meta, 0.0)
    timings, launches = {}, {}
    if want("kernels"):
        timings.update(phase_kernels(device, errs))
        timings.update(phase_flash_kernels(device, errs))
    if args.ab:
        phase_ab(device, args.ab)
    if want("programs") or want("profile") or want("engine"):
        cfg, masters, params = make_params(device)
        if want("programs"):
            phase_programs(device, cfg, params)
            phase_programs_int8(device, cfg, masters, params)
        if want("profile"):
            phase_profile(device, cfg, masters, params)
        if want("engine"):
            # Each serving path is read from its own run: the float
            # programs' counts from the float engine, the int8 programs'
            # from the int8 engine (each run zeroes every count first).
            counts, float_run, streams = phase_engine(device, cfg, params)
            launches.update({k: counts[k] for k in (
                "paged_attention", "paged_prefill_attention")})
            counts = phase_engine_int8(device, cfg, masters, float_run,
                                       streams)
            launches.update({k: counts[k] for k in (
                "paged_attention_int8", "paged_prefill_attention_int8")})
        del cfg, masters, params
        torch.cuda.empty_cache()
    if want("train"):
        launches.update(phase_train(device))

    kernels = []
    for name, (src, replaces) in meta.items():
        if name not in timings or name not in launches:
            continue
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("library_covers", "covered_ms",
                                 "library_see") if k in t}})
    if kernels:
        print(json.dumps({"kernels": kernels}), flush=True)
        RECORD["kernels"] = kernels
    if not only and len(kernels) != len(meta):
        raise AssertionError(f"kernels line has {len(kernels)} entries")
    os.makedirs(os.path.dirname(RECORD_PATH), exist_ok=True)
    with open(RECORD_PATH, "w") as f:
        json.dump(RECORD, f, indent=1)
    if only:
        return 0   # a partial run never prints the success line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
