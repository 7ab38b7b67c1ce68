#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, as the chip check runs it
    python3 chip_smoke.py --only kernels --ptxas   # build + kernel checks

Phases, one JSON line each (the whole record also goes to
build/chip_smoke.json):

1. card: the ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: both CUDA kernels compiled from ray_tpu_torch/ops/csrc for
   sm_90a, with the build seconds.
3. kernels: each kernel against its plain PyTorch version on the card at
   OPT-1.3B attention shapes (H=32, K=64), page sizes {16, 64}, fp32 and
   bf16, and at head dim 128; the ragged cases (length 1, mid-page, page
   boundary, full table, idle all-null slot; prefill C=256 and C=40 at
   ragged offsets, full and width-sliced tables) and the engine's own
   shapes (decode: 16 slots on a 2048-position table, lengths up to 2048;
   prefill: 16-row dispatches of 256, most rows inert), the largest error
   printed beside its bound, long rows on their own; then each kernel,
   checked once more on the inputs it is timed on, timed (CUDA events) at
   B=16, 1024-token contexts, page size 64, bf16, beside its bound, its
   plain version's time and F.scaled_dot_product_attention on the
   gathered timeline (a yardstick only: the port never calls it).
4. programs: prefill_chunk_paged and decode_step_paged at full opt_1_3b
   width (bf16, random weights from a seed), attn_impl "kernel" vs
   "gather" on copies of one pool.
5. profile: torch.profiler over one fused decode window and one prefill
   dispatch at the engine's shapes (device busy time, idle share, top ops).
6. engine: LLMEngine(opt_1_3b, bf16) serving 16 seeded prompts of 128-1536
   tokens through start()/submit(), 32 greedy tokens each, with the
   kernel launch counters zeroed just before and read just after.
7. the kernels line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failure raises: the script exits non-zero without the last line.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import os
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
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import LLMEngine

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
}
PROGRAM_LOGIT_MAE = 2e-2       # kernel vs gather programs, bf16, 24 layers

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


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ cases

def paged_pool(rng, lengths, *, ps, n_pg, dtype, device, heads=(H, K),
               null_rows=()):
    """K/V pools and a [B, n_pg] page table for slots of the given
    lengths. Each slot gets the pages its length needs, drawn from a
    random permutation of the pool (the engine's pages are scattered);
    the rest of its row is the null page 0, and so is all of a row in
    null_rows (an idle slot, or a mid-prefill slot in a decode view)."""
    need = [0 if b in null_rows else -(-int(n) // ps)
            for b, n in enumerate(lengths)]
    assert max(need) <= n_pg, (need, n_pg)
    n_pages = sum(need) + 1

    def plane():
        return torch.from_numpy(rng.normal(
            size=(n_pages, ps, *heads)).astype(np.float32)).to(device, dtype)

    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((len(lengths), n_pg), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    return plane(), plane(), tables, np.asarray(lengths, np.int32)


def abs_v_attention(reference, q, kp, vp, *args):
    """S of the bf16 bound: the plain version on fp32 copies with |V|."""
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
    share = err / tol
    worst = int(err.flatten().argmax())
    res = {"max_abs_err": float(err.max()),
           "bound_at_max_err": float(tol.flatten()[worst]),
           "max_share_of_bound": float(share.max()),
           "long_rows": int(lg.sum())}
    if bool(lg.any()):
        res["long_max_abs_err"] = float(err[lg].max())
        res["long_max_share_of_bound"] = float(share[lg].max())
    if res["max_share_of_bound"] > 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: {res}")
    return res


def check_decode(rng, tag, lengths, *, ps, n_pg, dtype, device, heads,
                 null_rows=()):
    kp, vp, tables, lengths = paged_pool(
        rng, lengths, ps=ps, n_pg=n_pg, dtype=dtype, device=device,
        heads=heads, null_rows=null_rows)
    q = torch.from_numpy(rng.normal(size=(len(lengths), *heads)).astype(
        np.float32)).to(device, dtype)
    args = [torch.from_numpy(a).to(device) for a in (tables, lengths)]
    out = pa.paged_attention(q, kp, vp, *args)
    torch.cuda.synchronize()
    ref = pa.reference_paged_attention(q, kp, vp, *args)
    s_abs = abs_v_attention(pa.reference_paged_attention, q, kp, vp, *args)
    live = torch.ones(len(lengths), dtype=torch.bool, device=device)
    long = args[1] >= LONG_ROW
    return check_close(f"decode {tag}", out, ref, s_abs, dtype, live, long)


def check_prefill(rng, tag, rows, C, *, ps, n_pg, width, dtype, device,
                  heads):
    """rows: (offset, valid tokens) per slot; (0, 0) is an inert row with
    an all-null table. The pool has the pages of n_pg·ps positions; the
    kernel gets the first ``width`` pages of the table."""
    lens = [o + n for o, n in rows]
    inert = {b for b, n in enumerate(lens) if n == 0}
    kp, vp, tables, lens = paged_pool(
        rng, [n_pg * ps if n else 0 for n in lens], ps=ps, n_pg=n_pg,
        dtype=dtype, device=device, heads=heads, null_rows=inert)
    lens = np.array([o + n for o, n in rows], np.int32)
    offs = np.array([o for o, _ in rows], np.int32)
    q = torch.from_numpy(rng.normal(size=(len(rows), C, *heads)).astype(
        np.float32)).to(device, dtype)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (tables[:, :width], offs, lens)]
    out = pa.paged_prefill_attention(q, kp, vp, *args)
    torch.cuda.synchronize()
    ref = pa.reference_paged_prefill_attention(q, kp, vp, *args)
    s_abs = abs_v_attention(pa.reference_paged_prefill_attention,
                            q, kp, vp, *args)
    # Inert rows (lengths 0) are defined differently by the kernel
    # (zeros, the l == 0 guard) and the gather version (mean of V).
    live_slot = args[2] > 0
    if not torch.all(out[~live_slot].float() == 0):
        raise AssertionError(f"prefill {tag}: inert row not zero")
    c = torch.arange(C, device=device)
    attended = torch.minimum(args[2][:, None], args[1][:, None] + c + 1)
    live = live_slot[:, None].expand(-1, C)
    return check_close(f"prefill {tag}", out, ref, s_abs, dtype, live,
                       attended >= LONG_ROW)


def phase_kernels(device, errs):
    """Each kernel against its plain version: OPT-1.3B's heads at page
    sizes 16 and 64 in fp32 and bf16, then head dim 128 (the kernels'
    other tensor-core and vector-width instantiation). Cases: the ragged
    edge cases on a narrow table; the engine's decode view (16 slots, a
    table of CAP positions, ragged lengths up to CAP, an idle and a
    mid-prefill slot); prefill chunks at ragged offsets, full and width-
    sliced tables, C=256 (the engine's chunk) and C=40 (a partial query
    tile); and the engine's prefill dispatches (16 rows of 256, most of
    them inert)."""
    rng = np.random.default_rng(0)
    cases = []
    grid = [((H, K), ps, dt) for ps in (16, 64)
            for dt in (torch.float32, torch.bfloat16)]
    grid += [((16, 128), 64, dt) for dt in (torch.float32, torch.bfloat16)]

    def record(kernel, tag, res):
        errs[kernel] = max(errs[kernel], res["max_abs_err"])
        cases.append({"kernel": kernel, "case": tag, **res})

    for heads, ps, dtype in grid:
        dn = str(dtype).split(".")[1]
        kw = dict(ps=ps, dtype=dtype, device=device, heads=heads)
        tag = f"ps={ps} {dn} heads={heads[0]}x{heads[1]}"
        # Decode: length 1, mid-page, page boundary, full table, and an
        # idle slot (length 1 on the null page), table 4 pages wide.
        record("paged_attention", f"{tag} edge cases", check_decode(
            rng, tag, [1, ps // 2 + 1, ps, 4 * ps, 1], n_pg=4,
            null_rows={4}, **kw))
        # Decode as the engine runs it: 16 slots, the full table of CAP
        # positions, the last two slots idle and mid-prefill (zeroed
        # row, a length past the null page's).
        n_pg = CAP // ps
        lengths = [1, ps // 2 + 1, ps, ps + 1, 700, 1023, 1024, 1025, 1531,
                   1999, CAP - ps, CAP - ps + 1, CAP - 1, CAP, 1, 1000]
        record("paged_attention", f"{tag} engine view B=16 n_pg={n_pg}",
               check_decode(rng, tag, lengths, n_pg=n_pg,
                            null_rows={14, 15}, **kw))
        # Prefill: chunk rows at ragged offsets against a 1536-token
        # table, full width and width-sliced; C=256 and C=40.
        n_pg = 1536 // ps
        for C, width in ((256, n_pg), (256, n_pg // 2), (40, n_pg // 2)):
            cap = width * ps
            rows = [(0, C), (ps, C), (cap - C, C), (ps + 3, 1),
                    (cap - 40, 40), (0, 0)]   # last: inert row
            ptag = f"{tag} C={C} width={width}"
            record("paged_prefill_attention", ptag, check_prefill(
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
            record("paged_prefill_attention", ptag, check_prefill(
                rng, ptag, rows, 256, n_pg=n_pg, width=n_pg, **kw))
    emit({"phase": "kernels_vs_plain", "tolerance": TOLERANCE,
          "cases": cases})
    return time_kernels(device, errs)


def time_kernels(device, errs):
    """Kernel, plain version and SDPA at the main path's decode and
    prefill shapes: B=16 slots, 1024-token contexts, ps=64, bf16. Each
    kernel's output is first held to its plain version's on these inputs."""
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
    args = (tables, lengths)
    out = pa.paged_attention(q, kp, vp, *args)
    torch.cuda.synchronize()
    every = torch.ones(B, dtype=torch.bool, device=device)
    check = check_close(
        "decode timing shape", out, pa.reference_paged_attention(
            q, kp, vp, *args), abs_v_attention(
            pa.reference_paged_attention, q, kp, vp, *args), dt, every,
        lengths >= LONG_ROW)
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check["max_abs_err"])
    ms = cuda_time_ms(lambda: pa.paged_attention(q, kp, vp, *args))
    plain = cuda_time_ms(lambda: pa.reference_paged_attention(
        q, kp, vp, *args), iters=10)
    qs = q[:, :, None, :]
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qs, kt, vt))
    nbytes = (2 * B * T * H * K * item + 2 * B * H * K * item
              + tables.numel() * 4 + B * 4)
    flops = 4 * B * H * T * K
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    timings["paged_attention"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
        check=check, shape=f"B={B} H={H} K={K} ctx={T} ps={ps} bf16")

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
    ms = cuda_time_ms(lambda: pa.paged_prefill_attention(qp, kp, vp, *args))
    plain = cuda_time_ms(lambda: pa.reference_paged_prefill_attention(
        qp, kp, vp, *args), iters=5)
    qpos = off + torch.arange(C, device=device)
    mask = torch.arange(T, device=device)[None, :] <= qpos[:, None]
    qpt = qp.transpose(1, 2).contiguous()
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qpt, kt, vt, attn_mask=mask))
    nbytes = (2 * B * T * H * K * item + 2 * B * C * H * K * item
              + tables.numel() * 4 + 2 * B * 4)
    attended = sum(off + c + 1 for c in range(C))
    flops = 4 * B * H * K * attended
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    timings["paged_prefill_attention"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
        check=check,
        shape=f"B={B} C={C} H={H} K={K} ctx={T} offset={off} ps={ps} bf16")
    emit({"phase": "kernel_timing", **timings})
    return timings


def make_params(device):
    cfg = gpt.GPTConfig.opt_1_3b(dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init_params(cfg, gen, device)
    served = pk.serving_params(cfg, params, device)
    del params
    torch.cuda.empty_cache()
    return cfg, served


def phase_programs(device, cfg, params):
    rng = np.random.default_rng(2)
    ps, C, width = 64, 256, 8
    pool = pk.init_paged_kv(cfg, 4 * width, ps, device=device)
    tables = np.zeros((4, width), np.int32)
    tables[:3] = np.arange(1, 3 * width + 1).reshape(3, width)
    offsets = np.array([0, 256, 0, 0], np.int32)
    n_valid = np.array([256, 200, 17, 0], np.int32)
    toks = rng.integers(1, cfg.vocab_size, size=(4, C)).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).to(device)
    pools = {impl: {k: v.clone() for k, v in pool.items()}
             for impl in ("kernel", "gather")}
    logits = {}
    for impl, p in pools.items():
        lg, _ = pk.prefill_chunk_paged(cfg, params, dev(toks), p, dev(tables),
                                       dev(offsets), dev(n_valid),
                                       attn_impl=impl)
        lg2, _ = pk.decode_step_paged(
            cfg, params, dev(toks[:, 0].copy()), p,
            dev((offsets + n_valid).astype(np.int32)), dev(tables),
            attn_impl=impl)
        torch.cuda.synchronize()
        logits[impl] = (lg[:3].float(), lg2[:3].float())
    out = {"phase": "programs", "config": "opt_1_3b bf16 24 layers",
           "mae_bound": PROGRAM_LOGIT_MAE}
    for i, name in enumerate(("prefill_chunk_paged", "decode_step_paged")):
        a, b = logits["kernel"][i], logits["gather"][i]
        if not (torch.isfinite(a).all() and a.shape == (3, cfg.vocab_size)):
            raise AssertionError(f"{name}: bad logits {tuple(a.shape)}")
        mae = float((a - b).abs().mean())
        out[name] = {"logit_mae": mae, "logit_max_abs": float(
            (a - b).abs().max()), "logit_mean_abs": float(b.abs().mean()),
            "argmax_equal": int((a.argmax(-1) == b.argmax(-1)).sum())}
        if mae > PROGRAM_LOGIT_MAE:
            raise AssertionError(f"{name}: kernel vs gather logit MAE {mae}"
                                 f" > {PROGRAM_LOGIT_MAE}")
    emit(out)


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

    return {
        "wall_ms": wall_plain * 1e3,
        "wall_ms_profiled": wall * 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / 1e3 / (wall_plain * 1e3)
                              if busy_us else None),
        "top_device_ms": table(by_dev, lambda e: dev_us(e) / 1e3),
        "top_host_ms": table(by_cpu, lambda e: e.self_cpu_time_total / 1e3),
        "host_op_calls": sum(e.count for e in ev
                             if e.key.startswith("aten::")),
    }


def phase_profile(device, cfg, params):
    """Where the time goes in the engine's two dispatches at the engine
    phase's shapes: one fused decode window (k=8, 16 slots at 1024-token
    contexts) and one prefill dispatch (16 rows x 256, two live rows)."""
    B, T, ps = 16, 1024, 64
    n_pg = T // ps
    pool = pk.init_paged_kv(cfg, B * n_pg, ps, device=device)
    tables = torch.arange(1, B * n_pg + 1, dtype=torch.int32,
                          device=device).reshape(B, n_pg)
    toks = torch.ones(B, dtype=torch.int32, device=device)
    pos = torch.full((B,), T - 16, dtype=torch.int32, device=device)
    temps = torch.zeros(B, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    decode = _profiled(lambda: pk.decode_multi_paged(
        cfg, params, toks, pool, pos, tables, 8, temps, gen,
        attn_impl="kernel"))
    decode["per_step_wall_ms"] = decode["wall_ms"] / 8
    ptoks = torch.ones(B, 256, dtype=torch.int32, device=device)
    offs = torch.zeros(B, dtype=torch.int32, device=device)
    nv = torch.from_numpy(np.array([256, 256] + [0] * (B - 2),
                                   np.int32)).to(device)
    prefill = _profiled(lambda: pk.prefill_chunk_paged(
        cfg, params, ptoks, pool, tables[:, :4].contiguous(), offs, nv,
        attn_impl="kernel"))
    emit({"phase": "profile", "decode_window_k8": decode,
          "prefill_dispatch_16x256": prefill})


def phase_engine(device, cfg, params):
    eng = LLMEngine(cfg, params, n_slots=16, max_len=2048, page_size=64,
                    prefill_chunk=256, prefill_token_budget=512,
                    attn_impl="kernel", device=device)
    rng = np.random.default_rng(3)
    lengths = rng.integers(128, 1537, size=16)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in lengths]
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t0 = time.perf_counter()
    eng.start()
    try:
        reqs = [eng.submit(p, max_tokens=32) for p in prompts]
        for r in reqs:
            if not r.done.wait(timeout=600):
                raise AssertionError("engine request timed out")
    finally:
        eng.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_prefill_attention": pa.paged_prefill_attention.launches}
    errors = [r.error for r in reqs if r.error is not None]
    if errors:
        raise AssertionError(f"engine request errors: {errors[:3]}")
    for r in reqs:
        if len(r.out_ids) != 32 or r.truncated or not all(
                0 <= t < cfg.vocab_size for t in r.out_ids):
            raise AssertionError(f"bad output for {r.request_id}: "
                                 f"{len(r.out_ids)} tokens")
    acc = eng.page_accounting()
    if not (acc["closure"] and acc["refs_consistent"]
            and acc["free"] == acc["total"]):
        raise AssertionError(f"page accounting open: {acc}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    m = eng.metrics()
    out = {"phase": "engine", "config": "opt_1_3b bf16",
           "requests": len(reqs), "prompt_tokens": int(lengths.sum()),
           "wall_s": wall, "launches": launches,
           "decode_steps": m["decode_steps"],
           "decode_windows": m["decode_windows"],
           "decode_launches_per_step": (
               launches["paged_attention"] / max(1, m["decode_steps"])),
           "decode_launches_per_window": (
               launches["paged_attention"] / max(1, m["decode_windows"])),
           "prefill_dispatches": m["prefill_dispatches"],
           "prefill_launches_per_dispatch": (
               launches["paged_prefill_attention"]
               / max(1, m["prefill_dispatches"])),
           "engine_decode_tok_s": m.get("engine_decode_tok_s"),
           "engine_prefill_tok_s": m.get("engine_prefill_tok_s"),
           "ttft_ms_p50": m.get("ttft_ms_p50"),
           "ttft_ms_p95": m.get("ttft_ms_p95"),
           "decode_step_ms_p50": m.get("decode_step_ms_p50"),
           "decode_step_ms_p95": m.get("decode_step_ms_p95"),
           "preemptions": m["preemptions"],
           "kv_pages_free_min": m["kv_pages_free_min"],
           "page_accounting": acc}
    emit(out)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases: kernels,programs,profile,"
                         "engine (default: all; the build always runs)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v (registers, spills)")
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
          "arch": "sm_90a"})

    errs = {"paged_attention": 0.0, "paged_prefill_attention": 0.0}
    timings = launches = None
    if want("kernels"):
        timings = phase_kernels(device, errs)
    if want("programs") or want("profile") or want("engine"):
        cfg, params = make_params(device)
        if want("programs"):
            phase_programs(device, cfg, params)
        if want("profile"):
            phase_profile(device, cfg, params)
        if want("engine"):
            launches = phase_engine(device, cfg, params)

    meta = {
        "paged_attention": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                            "ray_tpu/ops/paged_attention.py:55"),
        "paged_prefill_attention": ("ray_tpu_torch/ops/csrc/paged_prefill.cu",
                                    "ray_tpu/ops/paged_attention.py:206"),
    }
    if timings is not None and launches is not None:
        kernels = []
        for name, (src, replaces) in meta.items():
            t = timings[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
        RECORD["kernels"] = kernels
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
