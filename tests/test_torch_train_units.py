"""PyTorch port vs the JAX package: the pieces of distributed training
that need no process.

`MeshConfig.resolve`, the rank coordinates of the process mesh against
the JAX mesh's device order, `tree_to_shardings` + `shard_tree` against
the JAX ``NamedSharding``'s shard on the device at each mesh position,
the optimizer state's shardings, the axis groups `make_mesh` creates and
the axes it refuses, the two-dimensional shardings of the tp layouts,
`single_device_mesh`, and the configs, session and backend against the
reference's fields. A process mesh is built for each rank in turn
(``ProcessMesh(sizes, rank, ...)``, or `make_mesh` with the process
group's world faked): the layout is arithmetic, no collective runs.
Every comparison is exact (slices of the same numpy arrays).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.train import backend as jbackend
from ray_tpu.train import config as jconfig
from ray_tpu.train import session as jsession
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.mesh import MeshConfig, ProcessMesh
from ray_tpu_torch.parallel.sharding import shard_tree, tree_to_shardings
from ray_tpu_torch.train import backend as tbackend
from ray_tpu_torch.train import config as tconfig
from ray_tpu_torch.train import session as tsession
from ray_tpu_torch.train import spmd as tspmd
from ray_tpu_torch.train.optim import adafactor, adamw

CPU = torch.device("cpu")
# (dp, fsdp) of the process meshes held to the JAX mesh's layout.
LAYOUTS = [(2, 1), (4, 1), (8, 1), (1, 2), (1, 4), (1, 8), (2, 2)]


def _sizes(dp, fsdp):
    return MeshConfig(dp=dp, fsdp=fsdp).resolve(dp * fsdp)


def _meshes(dp, fsdp):
    """The process mesh of every rank, and the JAX mesh on as many of the
    forced host devices."""
    sizes = _sizes(dp, fsdp)
    jmesh = jmake_mesh(JMeshConfig(dp=dp, fsdp=fsdp, sp=1, tp=1),
                       devices=jax.devices()[:dp * fsdp])
    return [ProcessMesh(sizes, r, CPU, {}, None)
            for r in range(dp * fsdp)], jmesh


def test_mesh_config_resolve():
    for cls in (MeshConfig, JMeshConfig):
        assert cls(dp=2, fsdp=-1, tp=2).resolve(8) == {
            "dp": 2, "pp": 1, "fsdp": 2, "sp": 1, "ep": 1, "tp": 2,
        }
        assert cls().resolve(8)["fsdp"] == 8
        with pytest.raises(ValueError):
            cls(dp=3).resolve(8)
        with pytest.raises(ValueError):
            cls(dp=-1, fsdp=-1).resolve(8)
    for cfg in ({"dp": 2, "fsdp": -1}, {"dp": 4, "fsdp": 1, "tp": 2},
                {"fsdp": -1, "sp": 2}):
        assert (MeshConfig(**cfg).resolve(8)
                == JMeshConfig(**cfg).resolve(8))
    assert [f.name for f in dataclasses.fields(MeshConfig)] == [
        f.name for f in dataclasses.fields(JMeshConfig)]


@pytest.mark.parametrize("dp,fsdp", LAYOUTS)
def test_rank_coordinates_follow_the_jax_device_order(cpu_devices, dp, fsdp):
    meshes, jmesh = _meshes(dp, fsdp)
    assert jmesh.shape == meshes[0].shape
    for m in meshes:
        pos = tuple(m.coords[a] for a in tmesh.MESH_AXES)
        assert jmesh.devices[pos].id == m.rank


def _np_params(seed=3):
    cfg = jgpt.GPTConfig.tiny()
    jp = jgpt.init_params(cfg, jax.random.key(seed))
    return cfg, {k: np.asarray(v) for k, v in jp.items()}


@pytest.mark.parametrize("dp,fsdp", LAYOUTS)
def test_shard_tree_takes_the_jax_shard_of_each_rank(cpu_devices, dp, fsdp):
    """Each rank's pieces (`tree_to_shardings` on its process mesh, then
    `shard_tree` of the whole numpy leaves) equal the JAX array's shard on
    the device at the rank's mesh position."""
    jcfg, np_params = _np_params()
    meshes, jmesh = _meshes(dp, fsdp)
    jshard = jspmd.param_shardings(jgpt.logical_axes(jcfg), jmesh)
    logical = tgpt.logical_axes(tgpt.GPTConfig.tiny())
    for m in meshes:
        shardings = tree_to_shardings(logical, m)
        pieces = shard_tree(np_params, shardings)
        dev = jmesh.devices[tuple(m.coords[a] for a in tmesh.MESH_AXES)]
        for k, whole in np_params.items():
            s = shardings[k]
            assert s.spec == tuple(jshard[k].spec), k
            index = jshard[k].devices_indices_map(whole.shape)[dev]
            np.testing.assert_array_equal(pieces[k].numpy(), whole[index],
                                          err_msg=k)
            assert tuple(pieces[k].shape) == s.local_shape(whole.shape)
    w_up = tree_to_shardings(logical, meshes[-1])["w_up"]
    if fsdp > 1:      # (layers, embed→fsdp, mlp): 1/fsdp of embed per rank
        assert w_up.spec[1] == "fsdp" and w_up.dim == 1
        assert w_up.local_shape((2, 64, 128)) == (2, 64 // fsdp, 128)
    else:
        assert w_up.dim is None


def test_shard_tree_of_torch_leaves_and_batch_rows():
    sizes = _sizes(2, 2)
    x = torch.arange(8 * 3).reshape(8, 3)
    rows = [tmesh.batch_sharding(ProcessMesh(sizes, r, CPU, {}, None)).shard(x)
            for r in range(4)]
    torch.testing.assert_close(torch.cat(rows), x, rtol=0, atol=0)
    assert all(r.shape == (2, 3) for r in rows)
    whole = tmesh.replicated(ProcessMesh(sizes, 3, CPU, {}, None)).shard(x)
    torch.testing.assert_close(whole, x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not split evenly"):
        tmesh.batch_sharding(ProcessMesh(sizes, 0, CPU, {}, None)).shard(
            torch.zeros(6, 2))


@pytest.mark.parametrize("dp,fsdp", [(2, 1), (1, 2), (2, 2)])
def test_opt_state_shardings_follow_the_params(cpu_devices, dp, fsdp):
    """AdamW's moments shard like the parameters they mirror and have the
    rank's slice shapes; the count replicates: the JAX
    ``opt_state_shardings`` on the same mesh gives the same specs."""
    jcfg = jgpt.GPTConfig.tiny()
    meshes, jmesh = _meshes(dp, fsdp)
    jparams, jshard = jspmd.sharded_init(
        lambda r: jgpt.init_params(jcfg, r), jgpt.logical_axes(jcfg), jmesh,
        jax.random.key(0))
    jstate = jspmd.opt_state_shardings(optax.adamw(1e-2), jparams, jshard)
    cfg = tgpt.GPTConfig.tiny()
    opt = adamw(1e-2)
    for m in meshes:
        params, shardings = tspmd.sharded_init(tgpt, cfg, m)
        state = tspmd.opt_state_shardings(opt, params, shardings, m)
        real = opt.init(params)
        assert state.count.dim is None
        for k in params:
            for moment in ("mu", "nu"):
                s = getattr(state, moment)[k]
                assert s is shardings[k]
                assert s.spec == tuple(getattr(jstate[0], moment)[k].spec)
                assert (tuple(getattr(real, moment)[k].shape)
                        == s.local_shape(jparams[k].shape))


def test_sharded_init_keeps_the_slices_of_init_params():
    cfg = tgpt.GPTConfig.tiny()
    whole = tgpt.init_params(cfg, device="cpu")
    for r in range(4):
        m = ProcessMesh(_sizes(1, 4), r, CPU, {}, None)
        params, shardings = tspmd.sharded_init(tgpt, cfg, m)
        for k, v in shard_tree(whole, shardings).items():
            torch.testing.assert_close(params[k], v, rtol=0, atol=0)


class _FakeWorld:
    """``torch.distributed`` as a rank of ``world`` sees it; new_group
    records the ranks of each group created."""

    def __init__(self, monkeypatch, world, rank):
        import torch.distributed as dist

        self.created = []
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
        monkeypatch.setattr(dist, "new_group", self.new_group)

    def new_group(self, ranks):
        self.created.append(tuple(ranks))
        return tuple(ranks)


@pytest.mark.parametrize("rank", [0, 3, 6])
def test_make_mesh_creates_every_axis_group_in_one_order(monkeypatch, rank):
    fake = _FakeWorld(monkeypatch, 8, rank)
    m = tmesh.make_mesh(MeshConfig(dp=2, fsdp=4), device="cpu")
    assert m.shape["dp"] == 2 and m.shape["fsdp"] == 4
    assert m.coords == tmesh.mesh_coords(rank, m.shape)
    assert fake.created == [(0, 4), (1, 5), (2, 6), (3, 7),
                            (0, 1, 2, 3), (4, 5, 6, 7)]
    for ax in ("dp", "fsdp"):
        others = {a: c for a, c in m.coords.items() if a != ax}
        assert rank in m.groups[ax]
        assert all({a: c for a, c in tmesh.mesh_coords(r, m.shape).items()
                    if a != ax} == others for r in m.groups[ax])


@pytest.mark.parametrize("axis", ["tp", "sp", "ep", "pp"])
def test_make_mesh_refuses_other_axes_across_processes(monkeypatch, axis):
    """sp, ep and pp > 1 raise; tp spans processes: at 8 ranks, fsdp 4 x
    tp 2, the fsdp groups and then the tp groups (ranks that differ on
    that axis alone; every live axis together is the default group)."""
    fake = _FakeWorld(monkeypatch, 8, 5)
    if axis != "tp":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmesh.make_mesh(MeshConfig(**{"fsdp": -1, axis: 2}),
                            device="cpu")
        return
    m = tmesh.make_mesh(MeshConfig(fsdp=-1, tp=2), device="cpu")
    assert (m.shape["fsdp"], m.shape["tp"]) == (4, 2)
    assert fake.created == [(0, 2, 4, 6), (1, 3, 5, 7),
                            (0, 1), (2, 3), (4, 5), (6, 7)]
    assert m.groups == {"fsdp": (1, 3, 5, 7), "tp": (4, 5)}
    assert m.group(("tp",)) == ((4, 5), 2)
    assert m.group("fsdp") == ((1, 3, 5, 7), 4)


def test_make_mesh_builds_a_group_for_every_set_of_live_axes(monkeypatch):
    """dp 2 x fsdp 2 x tp 2: the groups of each axis, then of each pair
    (the hybrid's (dp, fsdp) reduces the gradients tp does not split), in
    one order on every rank; rank 6's own of each."""
    fake = _FakeWorld(monkeypatch, 8, 6)
    m = tmesh.make_mesh(MeshConfig(dp=2, fsdp=2, tp=2), device="cpu")
    assert fake.created == [
        (0, 4), (1, 5), (2, 6), (3, 7),            # dp
        (0, 2), (1, 3), (4, 6), (5, 7),            # fsdp
        (0, 1), (2, 3), (4, 5), (6, 7),            # tp
        (0, 2, 4, 6), (1, 3, 5, 7),                # dp, fsdp
        (0, 1, 4, 5), (2, 3, 6, 7),                # dp, tp
        (0, 1, 2, 3), (4, 5, 6, 7)]                # fsdp, tp
    assert m.groups == {"dp": (2, 6), "fsdp": (4, 6), "tp": (6, 7),
                        ("dp", "fsdp"): (0, 2, 4, 6),
                        ("dp", "tp"): (2, 3, 6, 7),
                        ("fsdp", "tp"): (4, 5, 6, 7)}
    assert m.group(("fsdp", "dp")) == ((0, 2, 4, 6), 4)
    assert m.group(("dp", "sp", "tp")) == ((2, 3, 6, 7), 4)
    assert m.group(("sp",)) == (None, 1)


def test_make_mesh_at_world_one_and_the_default_device(monkeypatch):
    m = tmesh.make_mesh(MeshConfig(dp=1, fsdp=1), device="cpu")
    assert m.world_size == 1 and m.groups == {} and m.backend is None
    assert m.all_reduce_mean(torch.ones(2), ("dp", "fsdp")).tolist() == [1, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tmesh.make_mesh()


def test_adafactor_raises_under_fsdp_and_runs_under_dp():
    """Adafactor builds under fsdp and under dp: its factored dims come
    from the whole leaf, its moments have the pieces' shapes (the
    collectives that join them run in the step: test_torch_train_tp.py)."""
    cfg = tgpt.GPTConfig.tiny()
    opt = adafactor(1e-2, min_dim_size_to_factor=32)
    fsdp = ProcessMesh(_sizes(1, 2), 0, CPU, {}, None)
    params, state, _ = tspmd.build_training(cfg, opt, process_mesh=fsdp)
    assert params["w_up"].shape == (2, 32, 128)
    # w_up [2, 64, 128] factors over (64, 128) as a whole: the row moment
    # drops mlp and keeps the rank's half of embed, the column moment
    # drops embed.
    assert state.v_row["w_up"].shape == (2, 32)
    assert state.v_col["w_up"].shape == (2, 128)
    dp = ProcessMesh(_sizes(2, 1), 1, CPU, {}, None)
    params, state, _ = tspmd.build_training(cfg, opt, process_mesh=dp)
    assert params["w_up"].shape == (2, 64, 128)
    assert state.v_row["w_up"].shape == (2, 64)


def _fields(cls):
    """(name, default, the default factory's name) of each field."""
    return [(f.name, f.default, getattr(f.default_factory, "__name__", None))
            for f in dataclasses.fields(cls)]


def test_configs_session_and_backend_match_the_reference():
    for name in ("FailureConfig", "CheckpointConfig", "RunConfig", "Result"):
        assert _fields(getattr(tconfig, name)) == _fields(
            getattr(jconfig, name)), name
    # Field for field, use_gpu in the place of use_tpu.
    assert _fields(tconfig.ScalingConfig) == [
        ("use_gpu" if n == "use_tpu" else n, d, f)
        for n, d, f in _fields(jconfig.ScalingConfig)]
    assert tconfig.ScalingConfig()._resources == {"CPU": 1}
    assert tconfig.ScalingConfig(use_gpu=True)._resources == {"CPU": 1,
                                                             "GPU": 1}
    assert tconfig.ScalingConfig(resources_per_worker={"GPU": 0.5}
                                 )._resources == {"GPU": 0.5}

    for fn in ("report", "get_world_rank", "get_world_size",
               "get_local_rank", "get_dataset_shard", "get_checkpoint"):
        with pytest.raises(RuntimeError) as ported_err:
            getattr(tsession, fn)(*(({},) if fn == "report" else ()))
        with pytest.raises(RuntimeError) as ref_err:
            getattr(jsession, fn)(*(({},) if fn == "report" else ()))
        assert str(ported_err.value) == str(ref_err.value)
    s = tsession.TrainSession(1, 2, local_rank=1, device=CPU)
    tsession._set_session(s)
    try:
        tsession.report({"x": 1}, checkpoint="ck")
        assert (tsession.get_world_rank(), tsession.get_world_size(),
                tsession.get_local_rank(), tsession.get_device(),
                tsession.get_checkpoint()) == (1, 2, 1, CPU, "ck")
        assert s.drain() == [{"x": 1, "_world_rank": 1,
                              "_has_checkpoint": True}]
    finally:
        tsession._set_session(None)

    assert 0 < tbackend.find_free_port() < 65536
    assert _fields(tbackend.BackendConfig) == _fields(jbackend.BackendConfig)
    default = tbackend.TorchBackendConfig()
    assert (default.device, default.backend, default.master_port,
            default.init_distributed) == (None, None, None, True)
    assert default._backend == "nccl"
    assert tbackend.TorchBackendConfig(device="cpu")._backend == "gloo"
    assert tbackend.TorchBackendConfig(backend="gloo")._backend == "gloo"
    assert (jbackend.JaxBackendConfig().init_distributed
            == default.init_distributed)


def test_local_ranks_count_within_each_node():
    from ray_tpu_torch.train.worker_group import local_ranks

    assert local_ranks(["a", "a", "b", "a", "b"]) == [0, 1, 0, 2, 1]
    assert local_ranks([None, None]) == [0, 1]


# (dp, fsdp, tp) of the two-dimensional layouts held to the JAX mesh.
TP_LAYOUTS = [(1, 1, 8), (1, 2, 4), (2, 2, 2), (4, 1, 2)]


@pytest.mark.parametrize("dp,fsdp,tp", TP_LAYOUTS)
def test_two_dimensional_shardings_take_the_jax_shard(cpu_devices, dp, fsdp,
                                                      tp):
    """Under tp a leaf may split on two dimensions (embed over fsdp,
    heads, mlp or vocab over tp): each rank's `Sharding.bounds`,
    `local_shape` and `shard` give the JAX array's shard on the device at
    the rank's mesh position, and the rank writes its piece in a sharded
    checkpoint when it is 0 on the axes that do not split the leaf."""
    jcfg, np_params = _np_params()
    sizes = MeshConfig(dp=dp, fsdp=fsdp, tp=tp).resolve(dp * fsdp * tp)
    jmesh = jmake_mesh(JMeshConfig(dp=dp, fsdp=fsdp, sp=1, tp=tp),
                       devices=jax.devices()[:dp * fsdp * tp])
    jshard = jspmd.param_shardings(jgpt.logical_axes(jcfg), jmesh)
    logical = tgpt.logical_axes(tgpt.GPTConfig.tiny())
    writers = {k: 0 for k in np_params}
    for r in range(dp * fsdp * tp):
        m = ProcessMesh(sizes, r, CPU, {}, None)
        dev = jmesh.devices[tuple(m.coords[a] for a in tmesh.MESH_AXES)]
        assert dev.id == r
        shardings = tree_to_shardings(logical, m)
        pieces = shard_tree(np_params, shardings)
        for k, whole in np_params.items():
            s = shardings[k]
            assert s.spec == tuple(jshard[k].spec), k
            index = jshard[k].devices_indices_map(whole.shape)[dev]
            assert s.bounds(whole.shape) == tuple(
                i.indices(n)[:2] for i, n in zip(index, whole.shape)), k
            np.testing.assert_array_equal(pieces[k].numpy(), whole[index],
                                          err_msg=k)
            assert tuple(pieces[k].shape) == s.local_shape(whole.shape)
            writers[k] += s.writer
        w_up = shardings["w_up"]
        assert [(x.dim, x.axes) for x in w_up.splits] == (
            [(1, ("fsdp",))] * (fsdp > 1) + [(2, ("tp",))])
        assert w_up.split_dim("tp") == 2 and w_up.count == fsdp * tp
        if fsdp > 1:
            with pytest.raises(ValueError, match="2 dimensions"):
                w_up.dim
    # Every piece is written by exactly one rank.
    for k, whole in np_params.items():
        assert writers[k] == tree_to_shardings(
            logical, ProcessMesh(sizes, 0, CPU, {}, None))[k].count, k


def test_sharding_shard_cuts_two_dimensions_of_torch_and_numpy_leaves():
    sizes = MeshConfig(dp=1, fsdp=2, tp=2).resolve(4)
    x = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    got = {}
    for r in range(4):
        s = ProcessMesh(sizes, r, CPU, {}, None).sharding(
            (None, "fsdp", "tp"))
        assert s.bounds(x.shape) == ((0, 2), (2 * (r // 2), 2 * (r // 2) + 2),
                                     (3 * (r % 2), 3 * (r % 2) + 3))
        got[r] = s.shard(x)
        torch.testing.assert_close(s.shard(x.numpy()), got[r], rtol=0, atol=0)
        assert got[r].is_contiguous() and got[r].shape == (2, 2, 3)
    top = torch.cat([got[0], got[1]], dim=2)
    bottom = torch.cat([got[2], got[3]], dim=2)
    torch.testing.assert_close(torch.cat([top, bottom], dim=1), x,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not split evenly"):
        ProcessMesh(sizes, 0, CPU, {}, None).sharding(
            (None, "fsdp", "tp")).shard(torch.zeros(2, 4, 5))


def test_single_device_mesh(monkeypatch):
    """A world-1 process mesh: on the CPU when asked, cuda by default,
    raising without a GPU (the JAX twin takes the first device)."""
    m = tmesh.single_device_mesh("cpu")
    assert m.world_size == 1 and m.device == CPU and m.groups == {}
    assert all(n == 1 for n in m.shape.values())
    assert m.sharding(("fsdp", "tp")).splits == ()
    assert m.all_reduce_mean(torch.ones(2), ("dp", "fsdp", "tp")).tolist() \
        == [1, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tmesh.single_device_mesh()


class _TwoEqualRanks:
    """A tp mesh of two ranks holding the same partials: a sum over tp is
    twice the rank's own. Records the dtype and axes of each sum."""

    def __init__(self):
        self.sums = []

    def all_reduce_sum(self, t, axes):
        self.sums.append((t.dtype, tuple(axes)))
        return t * 2


def test_column_parallel_sums_input_gradients_in_fp32_once():
    """q, k and v as one column-parallel product: the input's gradient
    is the fp32 sum of the three partials, reduced over tp in ONE fp32
    all-reduce, then rounded once to bf16; each weight's gradient is its
    bf16 product, as one controller's."""
    from ray_tpu_torch.models.decode import _column_parallel

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=gen).bfloat16().requires_grad_()
    ws = [torch.randn(16, 4, generator=gen).bfloat16().requires_grad_()
          for _ in range(3)]
    mesh = _TwoEqualRanks()
    outs = _column_parallel(x, ws, mesh)
    assert all(torch.equal(o, x.detach() @ w.detach())
               for o, w in zip(outs, ws))
    sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs)).backward()
    assert mesh.sums == [(torch.float32, ("tp",))]
    gs = [torch.full((8, 4), i + 1.0) for i in range(3)]
    partial = sum(g @ w.detach().float().t() for g, w in zip(gs, ws))
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, (partial * 2).bfloat16())
    for g, w in zip(gs, ws):
        assert torch.equal(w.grad, x.detach().t() @ g.bfloat16())
    # one weight, fp32 logits (the vocab-parallel head): one product back
    head = ws[0].detach().requires_grad_()
    logits = _column_parallel(x.detach().requires_grad_(), head, mesh,
                              f32=True)
    assert logits.dtype == torch.float32 and logits.shape == (8, 4)


def test_build_training_plans_gpt_from_its_shardings_and_refuses_llama_tp():
    """GPT gets the `RankPlan` of the shardings build_training cut its
    pieces by (fsdp dims, tp, this rank's vocabulary rows); a model with
    no ``rank_plan`` (Llama) refuses tp across processes."""
    from ray_tpu_torch.models import llama as tllama

    cfg = tgpt.GPTConfig.tiny()
    sizes = MeshConfig(dp=1, fsdp=2, tp=2).resolve(4)
    mesh = ProcessMesh(sizes, 3, CPU, {}, None)          # fsdp 1, tp 1
    shardings = tspmd.param_shardings(tgpt.logical_axes(cfg), mesh)
    plan = tgpt.rank_plan(cfg, mesh, shardings)
    assert plan.tp is mesh and plan.mesh is mesh
    half = cfg.vocab_size // 2
    assert plan.vocab == (half, cfg.vocab_size)
    assert plan.fsdp_dims == {k: s.split_dim("fsdp")
                              for k, s in shardings.items()
                              if s.split_dim("fsdp") is not None}
    assert plan.fsdp_dims["w_up"] == 1 and plan.fsdp_dims["w_down"] == 2
    assert "b_up" not in plan.fsdp_dims          # mlp over tp only
    dp = ProcessMesh(MeshConfig(dp=2, fsdp=1).resolve(2), 0, CPU, {}, None)
    assert tgpt.rank_plan(cfg, dp, tspmd.param_shardings(
        tgpt.logical_axes(cfg), dp)) is None
    lcfg = tllama.LlamaConfig.tiny()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tspmd.build_training(lcfg, adamw(1e-3), model=tllama,
                             process_mesh=mesh)
