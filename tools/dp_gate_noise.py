#!/usr/bin/env python3
"""How far dp = 2 strays from the single-controller step by bf16 noise
alone: chip_smoke.py's train_dist gate (every step's loss within 5e-4 of
the reference over 5 AdamW steps) measured over many batches.

    python3 tools/dp_gate_noise.py [N_BATCHES]    # on one H100

The train cell (gpt2_124m, S 1,024, B 8, bf16 over fp32 params, remat,
flash, adamw(3e-4, wd 0.1, mu bf16), seed 0) stepped on the whole batch,
and as dp = 2 in one process: each half batch's gradients, averaged, as
the ranks' all-reduce averages them (on seed 0's batch this reproduces
the gloo ranks' losses bit for bit). For each batch seed, with the flash
backward's delta from the rounded o (the JAX VJP's) and from o32 (o
before its rounding): the largest |loss difference| over the 5 steps and
the share of each matrix's first-step gradient elements whose sign the
split flips. One JSON object.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import gpt  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as fa  # noqa: E402
from ray_tpu_torch.train.optim import adamw, apply_updates  # noqa: E402
from ray_tpu_torch.train.spmd import build_training  # noqa: E402

STEPS = 5
LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def run(cfg, opt, device, seed, o32_head_dims):
    """→ (the reference's losses, dp's, the first step's sign flips), the
    backward's delta read from o32 at ``o32_head_dims``."""
    real = fa.O32_HEAD_DIMS
    fa.O32_HEAD_DIMS = o32_head_dims
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        params, state, step = build_training(cfg, opt, gen, device)
        dp_params = {k: v.detach().clone().requires_grad_(True)
                     for k, v in params.items()}
        dp_state = opt.init(dp_params)
        toks, tg = cs.train_batch_of(cfg.vocab_size, cs.TRAIN_B, cs.TRAIN_S,
                                     device, seed=seed)
        halves = ((toks[:cs.TRAIN_B // 2], tg[:cs.TRAIN_B // 2]),
                  (toks[cs.TRAIN_B // 2:], tg[cs.TRAIN_B // 2:]))
        ref, dp, flips = [], [], None
        for _ in range(STEPS):
            (la, ga), (lb, gb) = (step.grads_of(dp_params, h)
                                  for h in halves)
            grads = {k: (ga[k] + gb[k]) / 2 for k in ga}
            del ga, gb
            if flips is None:
                _loss, full = step.grads_of(params, (toks, tg))
                flips = {k: float((torch.sign(grads[k])
                                   != torch.sign(full[k])).float().mean())
                         for k in LEAVES}
                del full
            params, state, loss = step(params, state, (toks, tg))
            ref.append(float(loss))
            updates, dp_state = opt.update(grads, dp_state, dp_params)
            apply_updates(dp_params, updates)
            dp.append(float((la.detach() + lb.detach()) / 2))
        return ref, dp, flips
    finally:
        fa.O32_HEAD_DIMS = real


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_gate_noise: no CUDA device", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = gpt.GPTConfig.gpt2_124m(max_seq=cs.TRAIN_S, remat=True,
                                  attn_impl="flash")
    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    out = {"card": cs.card_line(), "gate": cs.TRAIN_LOSS_TOL, "steps": STEPS}
    for name, dims in (("delta from rounded o", ()),
                       ("delta from o32", (cfg.head_dim,))):
        rows = {}
        for seed in range(n):
            ref, dp, flips = run(cfg, opt, device, seed, dims)
            rows[seed] = {"max_gap": max(abs(a - b) for a, b in zip(ref, dp)),
                          "flips": flips}
        out[name] = {"batches": rows, "past_gate": sum(
            r["max_gap"] > cs.TRAIN_LOSS_TOL for r in rows.values())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
