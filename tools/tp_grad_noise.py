#!/usr/bin/env python3
"""How far a megatron tp rank's bf16 gradients stand from one
controller's, beside how far each stands from fp32's: whether tp is a
wrong bf16 run or another equally exact one.

    python3 tools/tp_grad_noise.py [TP]    # on the CPU, TP gloo ranks (2)

A small GPT (d 384, 6 heads of 64, 4 layers, d_ff 1,536, vocab 4,096,
S 256, B 8, bf16 over fp32 params, flash attention, seed 0) takes one
gradient step three ways on the same parameters and batch: on TP gloo
ranks of one host (``MeshConfig(tp=TP)``, the gradients gathered whole),
on one controller in bf16, and on one controller in fp32. Prints one
JSON object: each relative difference of the whole gradient, and the
largest over one layer's attention weights.
"""

import json
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

SHAPE = dict(d_model=384, n_heads=6, n_layers=4, d_ff=1536,
             vocab_size=4096, max_seq=256, rotary_dim=32, attn_impl="flash")
B, S = 8, 256


def setup(dtype):
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny(dtype=dtype, **SHAPE)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    batch = tuple(torch.from_numpy(a) for a in (toks, np.roll(toks, -1, 1)))
    return cfg, params, batch


def grads(params, step, batch):
    """The step's first-step gradients, as fp32 numpy."""
    _, g = step.grads_of(params, batch)
    return {k: v.float() for k, v in g.items()}


def one_controller(dtype):
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.optim import adamw

    cfg, whole, batch = setup(dtype)
    params, _, step = spmd.build_training(cfg, adamw(3e-4), device="cpu")
    with torch.no_grad():
        for k, v in whole.items():
            params[k].copy_(v)
    return {k: v.numpy() for k, v in grads(params, step, batch).items()}


def rank(r, tp, port, out):
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.mesh import (MeshConfig, batch_sharding,
                                             make_mesh)
    from ray_tpu_torch.parallel.sharding import shard_tree
    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.train.optim import adamw

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=r, world_size=tp)
    cfg, whole, batch = setup(torch.bfloat16)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=tp), device="cpu")
    params, _, step = spmd.build_training(cfg, adamw(3e-4),
                                          process_mesh=mesh)
    shardings = spmd.param_shardings(gpt.logical_axes(cfg), mesh)
    with torch.no_grad():
        for k, v in shard_tree(whole, shardings).items():
            params[k].copy_(v)
    rows = batch_sharding(mesh)
    g = grads(params, step, tuple(rows.shard(x) for x in batch))
    g = {k: mesh.gather_whole(v, shardings[k]).numpy() for k, v in g.items()}
    if r == 0:
        out.put(g)
    dist.destroy_process_group()


def rel(a, b):
    """(whole-gradient relative difference, the largest over one layer's
    wq/wk/wv/wo)."""
    whole = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in b)
                    / sum((b[k] ** 2).sum() for k in b))
    attn = max(np.linalg.norm(a[n][i] - b[n][i]) / np.linalg.norm(b[n][i])
               for n in ("wq", "wk", "wv", "wo")
               for i in range(b[n].shape[0]))
    return float(whole), float(attn)


def main():
    tp = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    torch.set_num_threads(2)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=rank, args=(r, tp, port, out))
             for r in range(tp)]
    for p in procs:
        p.start()
    g_tp = out.get(timeout=600)
    for p in procs:
        p.join()
    g_bf16 = one_controller(torch.bfloat16)
    g_fp32 = one_controller(torch.float32)
    print(json.dumps({
        "tp": tp, "shape": SHAPE,
        "tp_vs_one_controller_bf16": rel(g_tp, g_bf16),
        "tp_vs_fp32": rel(g_tp, g_fp32),
        "one_controller_bf16_vs_fp32": rel(g_bf16, g_fp32)}))


if __name__ == "__main__":
    main()
