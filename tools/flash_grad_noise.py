#!/usr/bin/env python3
"""Where the gap between flash and plain attention's gradients comes from,
on gptj_6b at full width and depth (the train_gptj_6b phase of
chip_smoke.py: S 1,024, B 8, bf16 SR masters, random weights from seed 0).

    python3 tools/flash_grad_noise.py     # on one H100, about 2 minutes

One step's gradients (nothing updated) with plain attention in bf16 (the
"xla" path), plain attention on fp32 q, k, v (``xla32``: no bf16 rounding
inside attention), and the flash path with its kernels and with variants
of its backward run as plain torch on the card:

- ``kernels``: the port's flash kernels (delta from the forward's
  unrounded o, fp32);
- ``plain, delta from rounded o``: the JAX VJP's delta = rowsum(dO · O)
  from the bf16 O;
- ``plain, delta from o32``: the plain backward with the port's delta;
- ``plain in fp32, delta from rounded o``: ds and p not rounded;
- ``plain, delta = sum p dP``: delta from the backward's own p.

Each against xla and xla32: the whole gradient's relative difference,
the worst (layer, attention leaf) and each leaf's worst layer, as one
JSON object. Two plain paths (xla against xla32) set the floor that any
bf16 path reads.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import gpt  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as fa  # noqa: E402


def errs(g, ref, n_layers):
    """The whole gradient's relative difference (leaf by leaf, a layer
    slice at a time) and the attention leaves' worst (layer, leaf)."""
    num = den = 0.0
    for name, b in ref.items():
        a = g[name]
        parts = range(n_layers) if a.dim() and a.shape[0] == n_layers else [
            None]
        for i in parts:
            x = (a if i is None else a[i]).float()
            y = (b if i is None else b[i]).float()
            num += float((x - y).square().sum())
            den += float(y.square().sum())
    per = sorted(((float((g[n][i].float() - ref[n][i].float()).norm()
                         / ref[n][i].float().norm()), n, i)
                  for n in cs.ATTN_LEAVES for i in range(n_layers)),
                 reverse=True)
    return {"whole": (num / den) ** 0.5, "worst": per[:4],
            "by_leaf_max": {n: max(e for e, m, _ in per if m == n)
                            for n in cs.ATTN_LEAVES}}


def probabilities(q, k, lse, causal, scale):
    s, mask = fa._scores(q, k, causal, scale)
    return torch.where(mask, torch.exp(s - lse.transpose(1, 2)[..., None]),
                       torch.zeros_like(s))


def plain_bwd(q, k, v, do, lse, delta, causal, scale, fp32=False):
    if fp32:
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        dq = fa.reference_flash_dq(q32, k32, v32, do32, lse, delta, causal,
                                   scale)
        dk, dv = fa.reference_flash_dkv(q32, k32, v32, do32, lse, delta,
                                        causal, scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    dq = fa.reference_flash_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *fa.reference_flash_dkv(q, k, v, do, lse, delta, causal,
                                        scale))


def rounded_o(q, k, v, o32, lse, do, dlse, causal, scale):
    delta = fa.flash_delta(o32.to(q.dtype), do, dlse)
    return plain_bwd(q, k, v, do, lse, delta, causal, scale)


def from_o32(q, k, v, o32, lse, do, dlse, causal, scale):
    delta = fa.flash_delta(o32, do, dlse)
    return plain_bwd(q, k, v, do, lse, delta, causal, scale)


def fp32_rounded_o(q, k, v, o32, lse, do, dlse, causal, scale):
    delta = fa.flash_delta(o32.to(q.dtype), do, dlse)
    return plain_bwd(q, k, v, do, lse, delta, causal, scale, fp32=True)


def exact_delta(q, k, v, o32, lse, do, dlse, causal, scale):
    p = probabilities(q, k, lse, causal, scale)
    dp = torch.einsum("bshk,bthk->bhst", do.float(), v.float())
    delta = (p * dp).sum(-1).transpose(1, 2)
    del p, dp
    if dlse is not None:
        delta = delta - dlse.float()
    return plain_bwd(q, k, v, do, lse, delta.contiguous(), causal, scale)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_grad_noise: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = gpt.GPTConfig.gptj_6b(max_seq=cs.SR_S, attn_impl="flash",
                                param_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    params, _state, _step = cs.build_training(
        cfg, cs.adafactor(3e-4), gen, device, stochastic_round=True)
    del _state, _step
    batch = cs.train_batch_of(cfg.vocab_size, cs.SR_B, cs.SR_S, device)
    L = cfg.n_layers
    t0 = time.perf_counter()
    real_ref, real_bwd = fa.reference_attention, fa.flash_bwd

    def attn32(q, k, v, *, causal=True, **kw):
        return real_ref(q.float(), k.float(), v.float(), causal=causal,
                        **kw).to(q.dtype)

    fa.reference_attention = attn32
    try:
        l32, g32 = cs.loss_and_grads(cfg, params, batch, "xla")
    finally:
        fa.reference_attention = real_ref
    lx, gx = cs.loss_and_grads(cfg, params, batch, "xla")
    out = {"card": cs.card_line(), "losses": {"xla32": l32, "xla": lx},
           "xla vs xla32": errs(gx, g32, L)}
    for name, bwd in (("kernels", real_bwd),
                      ("plain, delta from rounded o", rounded_o),
                      ("plain, delta from o32", from_o32),
                      ("plain in fp32, delta from rounded o", fp32_rounded_o),
                      ("plain, delta = sum p dP", exact_delta)):
        fa.flash_bwd = bwd
        try:
            lf, gf = cs.loss_and_grads(cfg, params, batch, "flash")
        finally:
            fa.flash_bwd = real_bwd
        out["losses"][name] = lf
        out[f"flash {name} vs xla"] = errs(gf, gx, L)
        out[f"flash {name} vs xla32"] = errs(gf, g32, L)
        del gf
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
