"""PyTorch port vs the JAX package: the training memory audit
(``ray_tpu_torch.train.memory_audit`` against
``ray_tpu.train.memory_audit``) and the logical-axis resolution it reads
(``ray_tpu_torch.models.partition.logical_to_spec`` against
``ray_tpu.models.partition.logical_to_spec``).

Every (config, mesh shape, optimizer, batch, param and grad bytes, hbm)
that tests/test_sharding_audit.py audits, and ``llama3_8b`` on one
H100 as ``chip_smoke.py`` train_llama audits it, must give the same
report integer for integer: the arithmetic is the same, so no tolerance.
"""

import math

import pytest

from jax.sharding import NamedSharding

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import DEFAULT_LOGICAL_RULES as J_RULES
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.sharding import logical_to_spec as j_logical_to_spec
from ray_tpu.train import memory_audit as jaudit
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.partition import logical_to_spec
from ray_tpu_torch.parallel.mesh import DEFAULT_LOGICAL_RULES
from ray_tpu_torch.train import memory_audit as taudit

ONE = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
FSDP = lambda n: {"dp": 1, "fsdp": n, "sp": 1, "tp": 1}

# (model, preset, config kwargs, mesh shape, audit kwargs): the cases of
# tests/test_sharding_audit.py, then the chip run's llama3_8b.
CASES = [
    *[("gpt", "gptj_6b", dict(max_seq=1024, loss_chunk=256), FSDP(n), {})
      for n in (2, 8, 16, 64)],
    ("gpt", "gpt2_350m", dict(max_seq=1024, loss_chunk=256), ONE, {}),
    ("gpt", "opt_1_3b", dict(max_seq=1024, loss_chunk=256), ONE, {}),
    ("gpt", "opt_1_3b", dict(max_seq=1024, loss_chunk=256), ONE,
     dict(optimizer="adafactor")),
    *[("gpt", "gpt2_2_7b", dict(max_seq=1024, loss_chunk=128), ONE,
       dict(optimizer="adafactor", batch_per_device=8, **kw))
      for kw in ({"param_bytes": 2, "grad_bytes": 2}, {})],
    *[("gpt", "gptj_6b", dict(max_seq=1024, loss_chunk=128), mesh,
       dict(optimizer="adafactor", batch_per_device=4, param_bytes=2,
            grad_bytes=2)) for mesh in (ONE, FSDP(2))],
    ("gpt", "tiny_untied", {}, {"dp": 1, "fsdp": 4, "sp": 1, "tp": 2}, {}),
    ("llama", "llama3_8b", dict(max_seq=4096), ONE,
     dict(optimizer="adafactor", param_bytes=2, grad_bytes=2, hbm="h100")),
    ("llama", "llama3_8b", dict(max_seq=4096), {"dp": 1, "fsdp": 8, "sp": 1,
                                                "tp": 4}, {}),
]
MODELS = {"gpt": ((jgpt, jgpt.GPTConfig), (tgpt, tgpt.GPTConfig)),
          "llama": ((jllama, jllama.LlamaConfig),
                    (tllama, tllama.LlamaConfig))}


def test_rules_equal_the_reference():
    assert DEFAULT_LOGICAL_RULES == J_RULES


@pytest.mark.parametrize("model,preset,kw,mesh,akw", CASES,
                         ids=[f"{c[1]}-{i}" for i, c in enumerate(CASES)])
def test_audit_equals_the_reference(model, preset, kw, mesh, akw):
    (jm, jcls), (tm, tcls) = MODELS[model]
    jcfg, tcfg = getattr(jcls, preset)(**kw), getattr(tcls, preset)(**kw)
    jkw = dict(akw)
    if jkw.get("hbm") == "h100":       # the reference's table has no GPU
        jkw["hbm"] = taudit.HBM_BYTES["h100"]
    want = jaudit.audit_training(jcfg, mesh, model=jm, **jkw)
    got = taudit.audit_training(tcfg, mesh, model=tm, **akw)
    assert got.per_device == want.per_device
    assert (got.total_bytes, got.hbm_bytes, got.mesh_shape, got.fits) == (
        want.total_bytes, want.hbm_bytes, want.mesh_shape, want.fits)
    assert str(got) == str(want)
    for name, spec in tm.param_specs(tcfg).items():
        jspec = j_logical_to_spec(spec["axes"], J_RULES,
                                  mesh=jaudit._FakeMesh(mesh))
        assert logical_to_spec(spec["axes"], mesh=taudit._FakeMesh(
            mesh)) == tuple(jspec), name


def test_llama3_8b_fits_one_h100_with_bf16_masters():
    """The chip run's configuration: bf16 masters and grads with
    adafactor fit one H100; fp32 masters with adamw do not."""
    cfg = tllama.LlamaConfig.llama3_8b(max_seq=4096)
    rep = taudit.audit_training(cfg, ONE, model=tllama, optimizer="adafactor",
                                param_bytes=2, grad_bytes=2, hbm="h100")
    assert rep.fits, f"\n{rep}"
    assert rep.per_device["params"] == 2 * tllama.num_params(cfg)
    assert not taudit.audit_training(cfg, ONE, model=tllama,
                                     hbm="h100").fits
    assert taudit.HBM_BYTES["v5e"] == jaudit.HBM_BYTES["v5e"]


def test_shard_elems_matches_named_sharding_on_live_mesh(cpu_devices):
    """The port's shard sizing equals jax's NamedSharding.shard_shape on
    the 8-device host mesh for every parameter of a tiny model, as the
    reference's test holds its own."""
    mesh = make_mesh(MeshConfig(dp=1, fsdp=4, sp=1, tp=2))
    cfg = tgpt.GPTConfig.tiny_untied()
    for name, spec in tgpt.param_specs(cfg).items():
        pspec = logical_to_spec(spec["axes"], mesh=mesh)
        jspec = j_logical_to_spec(spec["axes"], J_RULES, mesh=mesh)
        want = math.prod(NamedSharding(mesh, jspec).shard_shape(
            spec["shape"]))
        assert taudit._shard_elems(spec["shape"], pspec,
                                   dict(mesh.shape)) == want, name
