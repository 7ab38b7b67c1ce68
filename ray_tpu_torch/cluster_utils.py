"""In-process multi-node test harness.

Parity with the reference's `ray.cluster_utils.Cluster`
(`python/ray/cluster_utils.py:99,165,238`): N raylet
processes ("nodes") on one machine sharing one GCS, with add_node /
remove_node for distributed-failure testing without real machines.
"""

from __future__ import annotations

import os
import uuid

from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.node import Node


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: dict | None = None,
        _system_config: dict | None = None,
    ):
        self.config = Config.from_env().override(_system_config)
        self.session_dir = os.path.join(
            self.config.session_dir, f"cluster-{uuid.uuid4().hex[:8]}"
        )
        self.head_node: Node | None = None
        self.worker_nodes: list[Node] = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def gcs_address(self) -> tuple[str, int]:
        assert self.head_node is not None
        return self.head_node.gcs_address

    @property
    def address(self) -> str:
        host, port = self.gcs_address
        return f"{host}:{port}"

    def add_node(self, num_cpus: int = 4, resources: dict | None = None,
                 object_store_memory: int | None = None) -> Node:
        res = dict(resources or {})
        res.setdefault("CPU", num_cpus)
        config = self.config
        if object_store_memory is not None:
            import dataclasses

            config = dataclasses.replace(
                config, object_store_memory=object_store_memory
            )
        node = Node(
            config,
            head=self.head_node is None,
            resources=res,
            gcs_address=None if self.head_node is None else self.gcs_address,
            session_dir=os.path.join(
                self.session_dir, f"node-{uuid.uuid4().hex[:8]}"
            ),
        )
        node.start()
        if self.head_node is None:
            self.head_node = node
        else:
            self.worker_nodes.append(node)
        return node

    def wait_for_nodes(self, n: int, timeout: float = 30.0) -> None:
        """Block until `n` alive nodes are registered with the GCS
        (ref: cluster_utils.py wait_for_nodes)."""
        import asyncio
        import time

        from ray_tpu_torch.core import rpc

        async def count() -> int:
            conn = await rpc.connect(*self.gcs_address, timeout=10.0)
            try:
                view = await conn.call("get_cluster_view", {})
                return sum(1 for v in view.values() if v.get("alive", True))
            finally:
                await conn.close()

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if asyncio.run(count()) >= n:
                return
            time.sleep(0.2)
        raise TimeoutError(f"cluster did not reach {n} alive nodes")

    def remove_node(self, node: Node) -> None:
        """Hard-kill a node (raylet + its workers die with it)."""
        node.stop()
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)
        elif node is self.head_node:
            self.head_node = None

    def shutdown(self) -> None:
        for node in list(self.worker_nodes):
            self.remove_node(node)
        if self.head_node is not None:
            self.remove_node(self.head_node)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
