"""Sharded checkpoints of the port (``train/checkpoint.py``
`save_sharded`/`load_sharded`, the counterparts of the JAX package's
orbax pair): tiny GPT trained one step at fsdp = 2 on two gloo ranks of
a port cluster (`TorchTrainer`), saved by both ranks, then loaded back
at world 2 (each rank its own pieces, bitwise) and at world 1 in this
process (one whole copy, bitwise the parameters the ranks gather).
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch.parallel.sharding import tree_to_shardings
from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig, TorchTrainer
from ray_tpu_torch.train.checkpoint import load_sharded


def _save_and_reload(config):
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.mesh import (MeshConfig, batch_sharding,
                                             make_mesh)
    from ray_tpu_torch.train import session, spmd
    from ray_tpu_torch.train.checkpoint import load_sharded, save_sharded
    from ray_tpu_torch.train.optim import adamw

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    mesh = make_mesh(MeshConfig(dp=1, fsdp=2))
    params, opt_state, step = spmd.build_training(cfg, adamw(1e-2),
                                                  process_mesh=mesh)
    shardings = spmd.param_shardings(gpt.logical_axes(cfg), mesh)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    rows = batch_sharding(mesh)
    batch = tuple(rows.shard(torch.from_numpy(a))
                  for a in (toks, np.roll(toks, -1, axis=1)))
    params, opt_state, _ = step(params, opt_state, batch)
    save_sharded(params, config["path"], shardings)
    back = load_sharded(config["path"], shardings)
    with torch.no_grad():
        whole = {k: (p if shardings[k].dim is None else
                     mesh.all_gather(p, "fsdp", shardings[k].dim))
                 for k, p in params.items()}
    session.report({
        "bitwise": {k: (back[k].dtype == p.dtype
                        and torch.equal(back[k], p.detach()))
                    for k, p in params.items()},
        "whole": {k: v.detach().numpy() for k, v in whole.items()}})


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "ckpt")
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            _save_and_reload, train_loop_config={"path": path},
            scaling_config=ScalingConfig(num_workers=2),
            backend_config=TorchBackendConfig(device="cpu"),
        ).fit(timeout=240)
    finally:
        rt.shutdown()
    return path, {r["_world_rank"]: r for r in result.metrics_history}


def test_save_and_load_at_world_two_is_bitwise(saved):
    path, ranks = saved
    assert sorted(ranks) == [0, 1]
    for r in ranks.values():
        assert r["bitwise"] and all(r["bitwise"].values()), r["bitwise"]
    # each piece once: rank 1 holds the embed halves, rank 0 the rest too
    files = {k: torch.load(os.path.join(path, f"shard-0000{k}.pt"),
                           weights_only=True) for k in (0, 1)}
    assert "b_up" in files[0] and "b_up" not in files[1]   # not split
    assert files[1]["w_up"]["bounds"] == [[0, 2], [32, 64], [0, 128]]


def test_save_at_fsdp_two_loads_whole_at_world_one(saved):
    path, ranks = saved
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    target = tree_to_shardings(gpt.logical_axes(cfg),
                               make_mesh(MeshConfig(dp=1, fsdp=1),
                                         device="cpu"))
    whole = load_sharded(path, target)
    assert set(whole) == set(ranks[0]["whole"])
    for k, v in whole.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ranks[0]["whole"][k],
                                      err_msg=k)
        np.testing.assert_array_equal(ranks[1]["whole"][k],
                                      ranks[0]["whole"][k], err_msg=k)



def test_pieces_of_the_one_dimension_format_load(saved, tmp_path):
    """A directory whose pieces name one ``dim`` and its ``start`` and
    ``stop`` (None: the whole leaf), as pieces were written before a
    leaf could split on two dimensions, loads as the same leaves."""
    import json
    import shutil

    from ray_tpu_torch.train.checkpoint import INDEX_FILE

    path, ranks = saved
    old = tmp_path / "one_dim"
    old.mkdir()
    shutil.copy(os.path.join(path, INDEX_FILE), old / INDEX_FILE)
    with open(os.path.join(path, INDEX_FILE)) as f:
        shapes = {k: v["shape"] for k, v in json.load(f)["leaves"].items()}
    for k in (0, 1):
        name = f"shard-0000{k}.pt"
        pieces = torch.load(os.path.join(path, name), weights_only=True)
        for leaf, piece in pieces.items():
            box = piece.pop("bounds")
            cut = [d for d, (a, b) in enumerate(box)
                   if (a, b) != (0, shapes[leaf][d])]
            assert len(cut) <= 1, (leaf, box)
            dim = cut[0] if cut else None
            start, stop = box[dim] if cut else (0, 0)
            piece.update(dim=dim, start=start, stop=stop)
        torch.save(pieces, old / name)
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    target = tree_to_shardings(gpt.logical_axes(cfg),
                               make_mesh(MeshConfig(dp=1, fsdp=1),
                                         device="cpu"))
    whole = load_sharded(str(old), target)
    assert set(whole) == set(ranks[0]["whole"])
    for k, v in whole.items():
        np.testing.assert_array_equal(v.numpy(), ranks[0]["whole"][k],
                                      err_msg=k)
