"""The port's runtime, case for case as the JAX package's
``tests/test_core_units.py``.

Unit tests for the core substrate: IDs, config, serialization, store.

Mirrors the reference's C++ unit layer (`src/ray/*/test`)
— components tested in isolation without processes.
"""

import asyncio

import numpy as np
import pytest

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID


class TestIds:
    def test_hierarchy(self):
        job = JobID.from_int(7)
        actor = ActorID.of(job)
        assert actor.job_id == job
        task = TaskID.for_actor_task(actor)
        assert task.actor_id == actor
        assert task.job_id == job
        obj = ObjectID.for_return(task, 3)
        assert obj.task_id == task
        assert obj.return_index == 3
        assert not obj.is_put

    def test_put_bit(self):
        task = TaskID.for_task(JobID.from_int(1))
        obj = ObjectID.from_put(task, 9)
        assert obj.is_put
        assert obj.return_index == 9

    def test_roundtrip_hex(self):
        n = NodeID.from_random()
        assert NodeID.from_hex(n.hex()) == n
        assert hash(NodeID.from_hex(n.hex())) == hash(n)

    def test_size_validation(self):
        with pytest.raises(ValueError):
            JobID(b"toolong!")


class TestConfig:
    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_TORCH_HYBRID_THRESHOLD", "0.9")
        monkeypatch.setenv("RAY_TPU_TORCH_PRESTART_WORKERS", "2")
        c = Config.from_env()
        assert c.hybrid_threshold == 0.9
        assert c.prestart_workers == 2

    def test_system_config_override(self):
        c = Config().override({"default_max_retries": 7})
        assert c.default_max_retries == 7
        with pytest.raises(ValueError):
            Config().override({"bogus_key": 1})

    def test_json_roundtrip(self):
        c = Config(object_store_memory=123456)
        assert Config.from_json(c.to_json()) == c


class TestSerialization:
    def test_roundtrip_simple(self):
        for v in [1, "x", {"a": [1, 2]}, None, (3, 4)]:
            assert serialization.unpack(serialization.pack(v)) == v

    def test_numpy_zero_copy(self):
        arr = np.arange(10000, dtype=np.float32)
        data = serialization.pack(arr)
        out = serialization.unpack(data)
        np.testing.assert_array_equal(arr, out)
        # zero-copy: the array's buffer lives inside `data`
        assert not out.flags.owndata

    def test_closure(self):
        def f(x):
            return x * 3

        g = serialization.unpack(serialization.pack(f))
        assert g(4) == 12

    def test_tensor_to_host(self):
        """The port's counterpart of test_jax_array_to_host: a bf16 CPU
        tensor travels out-of-band (its bytes are the one buffer) and
        comes back bitwise, as a tensor that owns its memory."""
        import torch

        x = torch.arange(8.0).to(torch.bfloat16)
        head, views = serialization.serialize(x)
        assert [len(v) for v in views] == [16]
        out = serialization.unpack(serialization.pack(x))
        assert out.dtype == torch.bfloat16 and torch.equal(out, x)


class TestLocalObjectStore:
    def _store(self, tmp_path, capacity=1 << 20):
        import dataclasses

        cfg = dataclasses.replace(
            Config(), object_store_memory=capacity, object_spill_threshold=0.8
        )
        from ray_tpu_torch.core.object_store import LocalObjectStore

        return LocalObjectStore("deadbeef00", cfg, str(tmp_path / "spill"))

    def test_inline_put_get(self, tmp_path):
        async def go():
            store = self._store(tmp_path)
            obj = ObjectID.from_put(TaskID.for_task(JobID.from_int(1)), 1)
            store.put_inline(obj, b"hello")
            assert store.contains(obj)
            loc, data = await store.describe(obj)
            assert loc == "inline" and data == b"hello"
            store.shutdown()

        asyncio.run(go())

    def test_shm_create_seal(self, tmp_path):
        async def go():
            from ray_tpu_torch.core.object_store import attach_extent

            store = self._store(tmp_path)
            obj = ObjectID.from_put(TaskID.for_task(JobID.from_int(1)), 2)
            name, offset = await store.create(obj, 1024)
            view = attach_extent(name, offset, 1024)
            view[:5] = b"abcde"
            view.release()
            assert not store.contains(obj)
            store.seal(obj)
            assert store.contains(obj)
            assert store.read_bytes(obj, 0, 5) == b"abcde"
            store.free(obj)
            assert not store.contains(obj)
            store.shutdown()

        asyncio.run(go())

    def test_spill_and_restore(self, tmp_path):
        async def go():
            store = self._store(tmp_path, capacity=1 << 20)  # 1 MiB
            task = TaskID.for_task(JobID.from_int(1))
            objs = []
            for i in range(1, 9):  # 8 × 256 KiB > 0.8 MiB threshold
                obj = ObjectID.from_put(task, i)
                await store.create(obj, 256 * 1024)
                store.seal(obj)
                objs.append(obj)
            stats = store.stats()
            assert stats["spilled"] > 0, stats
            # all objects still readable (restore path)
            for obj in objs:
                loc, _ = await store.describe(obj)
                assert loc == "shm"
            store.shutdown()

        asyncio.run(go())

    def test_wait_sealed_timeout(self, tmp_path):
        async def go():
            store = self._store(tmp_path)
            obj = ObjectID.from_put(TaskID.for_task(JobID.from_int(1)), 1)
            ok = await store.wait_sealed(obj, timeout=0.05)
            assert not ok
            store.shutdown()

        asyncio.run(go())


class TestRpc:
    def test_call_roundtrip_and_errors(self):
        from ray_tpu_torch.core import rpc

        async def go():
            server = rpc.Server()

            async def echo(conn, p):
                return {"echo": p}

            async def fail(conn, p):
                raise ValueError("nope")

            server.register("echo", echo)
            server.register("fail", fail)
            host, port = await server.start()
            conn = await rpc.connect(host, port)
            out = await conn.call("echo", {"x": 1})
            assert out == {"echo": {"x": 1}}
            with pytest.raises(ValueError):
                await conn.call("fail", {})
            with pytest.raises(rpc.RpcError):
                await conn.call("unknown", {})
            await conn.close()
            await server.stop()

        asyncio.run(go())

    def test_concurrent_calls(self):
        from ray_tpu_torch.core import rpc

        async def go():
            server = rpc.Server()

            async def slow(conn, p):
                await asyncio.sleep(p["t"])
                return p["t"]

            server.register("slow", slow)
            host, port = await server.start()
            conn = await rpc.connect(host, port)
            t0 = asyncio.get_event_loop().time()
            out = await asyncio.gather(
                *[conn.call("slow", {"t": 0.1}) for _ in range(10)]
            )
            dt = asyncio.get_event_loop().time() - t0
            assert out == [0.1] * 10
            assert dt < 0.5  # concurrent, not serial (would be 1.0s)
            await conn.close()
            await server.stop()

        asyncio.run(go())

    def test_notify(self):
        from ray_tpu_torch.core import rpc

        async def go():
            got = asyncio.Event()
            payloads = []
            server = rpc.Server()

            async def sub(conn, p):
                conn.notify("hello", {"n": 42})
                return {}

            server.register("sub", sub)
            host, port = await server.start()

            def on_notify(method, payload):
                payloads.append((method, payload))
                got.set()

            conn = await rpc.connect(host, port, notify_handler=on_notify)
            await conn.call("sub", {})
            await asyncio.wait_for(got.wait(), 2)
            assert payloads == [("hello", {"n": 42})]
            await conn.close()
            await server.stop()

        asyncio.run(go())
