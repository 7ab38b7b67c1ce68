"""PyTorch port vs the JAX package: the partition rules and the tp mesh.

- `gpt.partition_rules()` through `match_partition_rules`: for every
  parameter of ``tiny`` (tied and untied) and of its int8
  `quantize_params`, the port's sharded dimension is the position of
  ``"tp"`` in the JAX `PartitionSpec` (None where JAX replicates); the
  same for `KV_POOL_PARTITION_RULES` on the float and int8 pools.
- The rule machinery: scalar leaves skip the table, an unmatched leaf is
  a `PartitionRuleError` naming its path, the first matching rule wins,
  nested paths join with ``/`` as in JAX.
- `split_head_planes`/`concat_head_planes`: byte-identical to JAX's on
  seeded numpy payloads (float and int8 planes, scale planes), the
  round trip is the identity, a torn payload and a non-divisible head
  dim raise as in JAX. On bf16 torch payloads (the port's KV page-set
  payloads) they split and join with torch, and the bits equal the
  numpy path's on the same int16 bits.
- `make_tp_mesh`: tp < 1 and tp beyond the visible CUDA devices raise;
  an explicit list may repeat a device.
- `shard_by_rules`: each shard's leaves are contiguous tensors of their
  own (no storage shared with the input or another shard), their
  concatenation along the rule's dimension is the input, replicated
  leaves equal it whole; a dimension tp does not divide raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import paged_kv as jpk
from ray_tpu.models import partition as jpart
from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import paged_kv as tpk
from ray_tpu_torch.models import partition as tpart


def _tp_dim(spec: PartitionSpec):
    """Position of the "tp" axis in a JAX spec, None where replicated."""
    dims = [i for i, ax in enumerate(spec) if ax == "tp"]
    assert len(dims) <= 1
    return dims[0] if dims else None


def _jax_dims(rules, tree):
    specs = jpart.match_partition_rules(rules, tree)
    return {k: _tp_dim(v) for k, v in specs.items()}


@pytest.mark.parametrize("name", ["tiny", "tiny_untied"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_param_rules_match_jax(name, quant):
    jcfg = jgpt.GPTConfig.by_name(name, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.by_name(name, dtype=torch.float32)
    jp = jgpt.init_params(jcfg, jax.random.key(0))
    if quant:
        jp = jgpt.quantize_params(jp)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tcfg,
                         device="cpu")
    assert set(tp) == set(jp)
    want = _jax_dims(jgpt.partition_rules(), jp)
    got = tpart.match_partition_rules(tgpt.partition_rules(), tp)
    assert got == want
    # The tp axis lands on the head / hidden dims.
    assert (got["wq"], got["wo"], got["w_up"], got["w_down"]) == (2, 1, 2, 1)
    if quant:
        assert (got["wq_scale"], got["w_up_scale"]) == (2, 2)
        assert got["wo_scale"] is None and got["w_down_scale"] is None


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_pool_rules_match_jax(kv_dtype):
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jpool = jpk.init_paged_kv(jcfg, 6, 4, kv_dtype=kv_dtype)
    tpool = tpk.init_paged_kv(tcfg, 6, 4, kv_dtype=kv_dtype, device="cpu")
    want = {k: _tp_dim(v) for k, v in jpart.match_partition_rules(
        jpk._kv_pool_partition_rules(), jpool).items()}
    got = tpart.match_partition_rules(tpk.KV_POOL_PARTITION_RULES, tpool)
    assert got == want
    assert got["k"] == got["v"] == tpart.KV_HEAD_AXIS == 3


def test_scalar_leaves_skip_the_table():
    tree = {"step": torch.zeros(()), "one": torch.ones(1),
            "w": torch.zeros(4, 4)}
    assert tpart.match_partition_rules(((r"^w$", 0),), tree) == {
        "step": None, "one": None, "w": 0}


def test_unmatched_leaf_is_typed_error():
    with pytest.raises(tpart.PartitionRuleError, match="mystery"):
        tpart.match_partition_rules(((r"^w$", None),),
                                    {"mystery": torch.zeros(4, 4)})
    assert issubclass(tpart.PartitionRuleError, ValueError)


def test_rule_precedence_is_list_order():
    tree = {"wq": torch.zeros(4, 4)}
    first = ((r"^wq$", 0), (r"^w", 1))
    assert tpart.match_partition_rules(first, tree)["wq"] == 0
    assert tpart.match_partition_rules(first[::-1], tree)["wq"] == 1


def test_nested_paths_join_with_slash():
    jtree = {"opt": {"mu": {"wq": jnp.zeros((4, 4))}, "b": [jnp.zeros(2)]}}
    ttree = {"opt": {"mu": {"wq": torch.zeros(4, 4)}, "b": [torch.zeros(2)]}}
    assert tpart.tree_path_names(ttree) == jpart.tree_path_names(jtree)
    dims = tpart.match_partition_rules(((r"mu/wq", 0), (r"b/0", None)),
                                       ttree)
    assert dims == {"opt": {"mu": {"wq": 0}, "b": [None]}}


def _payload(seed, tp_heads=8):
    rng = np.random.default_rng(seed)
    shape = (2, 3, 4, tp_heads, 8)
    return {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.standard_normal(shape).astype(np.float32),
            "k_scale": rng.random((2, 3)).astype(np.float32),
            "v_scale": rng.random((2, 3)).astype(np.float32)}


def _same_bytes(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_head_planes_byte_identical_to_jax(tp):
    payload = _payload(tp)
    split = tpart.split_head_planes(payload, tp)
    _same_bytes(split, jpart.split_head_planes(payload, tp))
    back = tpart.concat_head_planes(split, tp)
    _same_bytes(back, jpart.concat_head_planes(split, tp))
    _same_bytes(back, payload)


@pytest.mark.parametrize("tp", [2, 4])
def test_head_planes_bf16_torch_round_trip(tp):
    """bf16 K/V planes and bf16 scale planes, as a bf16 pool's payload:
    every split piece and the joined planes hold the bits the numpy path
    gives on the same int16 bits, and the round trip is the identity."""
    g = torch.Generator().manual_seed(tp)
    shape = (2, 3, 4, 8, 8)
    payload = {"k": torch.randn(shape, generator=g).to(torch.bfloat16),
               "v": torch.randn(shape, generator=g).to(torch.bfloat16),
               "k_scale": torch.rand((2, 3), generator=g).to(torch.bfloat16)}
    bits = {k: v.view(torch.int16).numpy() for k, v in payload.items()}
    split = tpart.split_head_planes(payload, tp)
    split_bits = tpart.split_head_planes(bits, tp)
    assert sorted(split) == sorted(split_bits)
    for name, piece in split.items():
        assert isinstance(piece, torch.Tensor) and piece.dtype == torch.bfloat16
        assert np.array_equal(piece.view(torch.int16).numpy(),
                              split_bits[name]), name
    back = tpart.concat_head_planes(split, tp)
    back_bits = tpart.concat_head_planes(split_bits, tp)
    assert sorted(back) == sorted(payload)
    for name, plane in back.items():
        assert plane.dtype == torch.bfloat16 and plane.is_contiguous()
        assert np.array_equal(plane.view(torch.int16).numpy(),
                              back_bits[name]), name
        assert torch.equal(plane.view(torch.int16),
                           payload[name].view(torch.int16)), name


def test_head_planes_errors_match_jax():
    payload = _payload(3)
    torn = tpart.split_head_planes(payload, 4)
    del torn["k@2"]
    for mod in (tpart, jpart):
        with pytest.raises(ValueError, match="torn"):
            mod.concat_head_planes(torn, 4)
        with pytest.raises(ValueError, match="not divisible"):
            mod.split_head_planes(payload, 3)


def test_make_tp_mesh_bounds():
    with pytest.raises(ValueError, match=">= 1"):
        tpart.make_tp_mesh(0)
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="exceeds"):
        tpart.make_tp_mesh(n_cuda + 1)
    with pytest.raises(ValueError, match="exceeds"):
        tpart.make_tp_mesh(3, devices=["cpu", "cpu"])
    cpu = torch.device("cpu")
    assert tpart.make_tp_mesh(2, devices=[cpu] * 4) == [cpu, cpu]
    assert tpart.make_tp_mesh(1, devices=["cpu"]) == [cpu]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_shard_by_rules_splits_and_reassembles(tp, quant):
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    params = tgpt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    if quant:
        params = tgpt.quantize_params(params)
    mesh = tpart.make_tp_mesh(tp, devices=["cpu"] * tp)
    rules = tgpt.partition_rules()
    dims = tpart.match_partition_rules(rules, params)
    shards = tpart.shard_by_rules(mesh, rules, params)
    assert len(shards) == tp
    ptrs = {t.data_ptr() for t in params.values()}
    for shard in shards:
        assert set(shard) == set(params)
        for name, t in shard.items():
            assert t.is_contiguous(), name
            assert t.data_ptr() not in ptrs, name
            ptrs.add(t.data_ptr())
    for name, full in params.items():
        pieces = [shard[name] for shard in shards]
        if dims[name] is None:
            assert all(torch.equal(p, full) for p in pieces), name
        else:
            assert pieces[0].shape[dims[name]] == full.shape[dims[name]] // tp
            assert torch.equal(torch.cat(pieces, dim=dims[name]), full), name


def test_shard_by_rules_pool_and_divisibility():
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    pool = tpk.init_paged_kv(cfg, 5, 4, kv_dtype="int8", device="cpu")
    pool["k"].random_(-127, 128)
    pool["k_scale"].uniform_()
    mesh = [torch.device("cpu")] * 2
    shards = tpart.shard_by_rules(mesh, tpk.KV_POOL_PARTITION_RULES, pool)
    assert shards[0]["k"].shape == (2, 6, 4, 4, 8)
    assert all(s["k"].is_contiguous() for s in shards)
    assert torch.equal(torch.cat([s["k"] for s in shards], dim=3),
                       pool["k"])
    assert all(torch.equal(s["k_scale"], pool["k_scale"]) for s in shards)
    assert shards[0]["k_scale"].data_ptr() != shards[1]["k_scale"].data_ptr()
    with pytest.raises(ValueError, match="not divisible"):
        tpart.shard_by_rules([torch.device("cpu")] * 3,
                             tpk.KV_POOL_PARTITION_RULES, pool)
