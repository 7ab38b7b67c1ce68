"""AIR glue of the port (ray_tpu_torch.air) against the JAX package's.

Mirrors ``tests/test_air.py`` case for case: Checkpoint conversions
(dict ↔ directory; ``from_params`` of the port's parameters, torch
tensors moved to the host, where the reference's jax arrays become
numpy), the ScalingConfig's resources (``use_gpu`` in the place of
``use_tpu``), and BatchPredictor over a Dataset, whose rows must equal
the JAX package's on the same construction.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tpu
import ray_tpu_torch
from ray_tpu import air as jair
from ray_tpu import data as jdata
from ray_tpu_torch import air, data
from ray_tpu_torch.air import Checkpoint, ScalingConfig


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


class TestCheckpoint:
    def test_dict_dir_roundtrip(self, tmp_path):
        for pkg in (jair, air):
            ck = pkg.Checkpoint.from_dict({"w": np.arange(4), "step": 7})
            d = ck.to_directory(str(tmp_path / f"ck-{pkg.__name__}"))
            out = pkg.Checkpoint.from_directory(d).to_dict()
            np.testing.assert_array_equal(out["w"], np.arange(4))
            assert out["step"] == 7

    def test_from_params_pytree(self):
        ref = jair.Checkpoint.from_params(
            {"layer": {"w": jnp.ones((2, 2)), "b": jnp.zeros(2)}},
            step=3).to_dict()
        params = {"layer": {"w": torch.ones(2, 2, requires_grad=True),
                            "b": torch.zeros(2)}}
        d = Checkpoint.from_params(params, step=3).to_dict()
        w = d["params"]["layer"]["w"]
        assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
        assert not w.requires_grad
        for k in ("w", "b"):
            np.testing.assert_array_equal(d["params"]["layer"][k].numpy(),
                                          ref["params"]["layer"][k])
        assert d["step"] == ref["step"] == 3

    def test_scaling_config_resources(self):
        assert ScalingConfig(num_workers=2)._resources == jair.ScalingConfig(
            num_workers=2)._resources == {"CPU": 1}
        assert ScalingConfig(use_gpu=True)._resources == {"CPU": 1, "GPU": 1}
        assert jair.ScalingConfig(use_tpu=True)._resources == {"CPU": 1,
                                                               "TPU": 4}


class TestBatchPredictor:
    def test_predict_over_dataset(self, clusters):
        def run(pkg, d):
            # Defined here so cloudpickle ships the class by value.
            class DoublePredictor(pkg.Predictor):
                @classmethod
                def from_checkpoint(cls, checkpoint, **kwargs):
                    p = cls()
                    p.scale = checkpoint.to_dict()["scale"]
                    return p

                def predict_batch(self, batch):
                    return {"out": batch["x"] * self.scale}

            ds = d.from_items([{"x": float(i)} for i in range(16)])
            bp = pkg.BatchPredictor.from_checkpoint(
                pkg.Checkpoint.from_dict({"scale": 3.0}), DoublePredictor)
            return bp.predict(ds, batch_size=4).take_all()

        rows = run(air, data)
        assert rows == run(jair, jdata)
        assert sorted(r["out"] for r in rows) == [3.0 * i for i in range(16)]
