#!/usr/bin/env python3
"""Whether the bf16 prefill could load page pieces of fewer than 8 rows by
TMA instead of gathering them: a probe of the design choice at the head of
ray_tpu_torch/ops/csrc/paged_prefill.cu.

    python3 tools/prefill_box_probe.py          # on one H100

It copies the kernel sources to build/box_probe, widens the box rule there
(`prefill_box_rows`: gcd(ps, key tile) at every page size, so boxes of 1,
2 or 4 rows land at 128- to 512-byte offsets of a 128-byte-swizzled tile),
builds that copy into its own library (chip_smoke.py `old_library`) and
runs the float program through its C entry point with plans of those box
rows. Each output is held to the plain version (the bf16 bound of
chip_smoke.py `share_of_bound`: a wrong swizzle reads far past it); then,
at chip_smoke.py's page-size timing shapes off the 8-row rule
(`PS_PREFILL_CASES`, ps 20), the probe's small boxes and this tree's
gathering producer are timed in turns (probe, tree, tree, probe) by
device time. One JSON object.
"""

import ctypes
import json
import math
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402

PROBE_DIR = os.path.join("build", "box_probe")
RULE = "  if (ps < 1 || ps % 8) return 0;"


def probe_library():
    """The kernel sources with the box rule widened, built apart."""
    src = os.path.join(PROBE_DIR, "ray_tpu_torch", "ops", "csrc")
    shutil.rmtree(PROBE_DIR, ignore_errors=True)
    shutil.copytree(os.path.join(_build.REPO_ROOT, "ray_tpu_torch", "ops",
                                 "csrc"), src)
    path = os.path.join(src, "paged_prefill.cu")
    with open(path) as f:
        text = f.read()
    if text.count(RULE) != 1:
        raise RuntimeError(f"the box rule is not {RULE!r} in {path}")
    with open(path, "w") as f:
        f.write(text.replace(RULE, "  if (ps < 1) return 0;"))
    return cs.old_library(PROBE_DIR)


def small_box_call(lib, q, kp, vp, args):
    """The probe library's float prefill, planned in boxes of gcd(ps, key
    tile) rows."""
    B, C, H, K = q.shape
    real = pa.prefill_box_rows
    pa.prefill_box_rows = lambda K, ps: math.gcd(ps, pa.key_tile(K))
    try:
        plan = pa.prefill_plan(q, kp, vp)
    finally:
        pa.prefill_box_rows = real
    maps = pa._c_array(plan.maps)
    out = torch.empty_like(q)
    _build.check(lib.rtt_paged_prefill_attention(
        1, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        *(a.data_ptr() for a in args), out.data_ptr(), B, C, H, K,
        kp.shape[1], args[0].shape[1], float(1 / np.sqrt(K)),
        ctypes.addressof(maps), torch.cuda.current_stream().cuda_stream),
        "probe prefill")
    return out, plan.box_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_box_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _build.build()
    lib = probe_library()
    rng = np.random.default_rng(0)
    out = {"card": cs.card_line(), "checks": [], "timings": {}}
    for K in (64, 256):
        for ps in (5, 6, 12, 20):
            q, kp, vp, args, _ = cs.prefill_case_at(rng, dev, (2, K), ps, 72,
                                                    300, False)
            got, rows = small_box_call(lib, q, kp, vp, args)
            ref = pa.reference_paged_prefill_attention(q, kp, vp, *args)
            s_abs = cs.abs_v_attention(pa.reference_paged_prefill_attention,
                                       q, kp, vp, *args)
            out["checks"].append({"K": K, "ps": ps, "box_rows": rows,
                                  "share_of_bf16_bound": cs.share_of_bound(
                                      got, ref, s_abs)})
    for tag, heads, ps, C, off in cs.PS_PREFILL_CASES:
        if ps % 8 == 0:
            continue
        q, kp, vp, args, _ = cs.prefill_case_at(rng, dev, heads, ps, C, off,
                                                False)
        probe = lambda: small_box_call(lib, q, kp, vp, args)[0]
        tree = lambda: pa.paged_prefill_attention(q, kp, vp, *args)
        turns = [cs.device_ms(f) for f in (probe, tree, tree, probe)]
        out["timings"][tag] = {
            "small_boxes_ms": [turns[0], turns[3]],
            "gathered_ms": [turns[1], turns[2]],
            "small_boxes_over_gathered": (turns[0] + turns[3])
            / (turns[1] + turns[2])}
    print(json.dumps(out), flush=True)
    bad = [c for c in out["checks"] if c["share_of_bf16_bound"] > 1.0]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
