"""Node providers: how the autoscaler actually gets machines.

Counterpart of ``ray_tpu/autoscaler/node_provider.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/autoscaler/node_provider.py` (interface)
with two built-ins:
- MockProvider — records launches/terminations, for pure scaling-logic
  tests (the reference's `util/mock.py` MockProvider role).
- LocalSubprocessProvider — each "node" is a real raylet subprocess joined
  to the head GCS (the fake_multi_node trick), so autoscaled capacity
  genuinely schedules tasks.

The GPU provider (`gcp_gpu.py`, in the place of the reference's TPU-pod
provider) implements the same interface with GCE calls; `NodeType`
carries the accelerator it requests.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any


@dataclasses.dataclass
class NodeType:
    name: str
    resources: dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    # The accelerator requested from the platform. The field keeps the
    # reference's name; for a GPU node it holds "<accelerator type>:
    # <count>", e.g. "nvidia-h100-80gb:8" (one provider node == one VM
    # with that many cards).
    topology: str | None = None


class NodeProvider:
    """Interface. Nodes are identified by provider-scoped string ids."""

    def non_terminated_nodes(self) -> list[str]:
        raise NotImplementedError

    def node_type(self, node_id: str) -> str:
        raise NotImplementedError

    def create_node(self, node_type: NodeType) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def is_ready(self, node_id: str) -> bool:
        return True


class MockProvider(NodeProvider):
    def __init__(self):
        self.nodes: dict[str, str] = {}  # id → type name
        self.launched: list[str] = []
        self.terminated: list[str] = []

    def non_terminated_nodes(self) -> list[str]:
        return list(self.nodes)

    def node_type(self, node_id: str) -> str:
        return self.nodes[node_id]

    def create_node(self, node_type: NodeType) -> str:
        node_id = f"mock-{len(self.launched)}-{uuid.uuid4().hex[:6]}"
        self.nodes[node_id] = node_type.name
        self.launched.append(node_id)
        return node_id

    def terminate_node(self, node_id: str) -> None:
        self.nodes.pop(node_id, None)
        self.terminated.append(node_id)


class LocalSubprocessProvider(NodeProvider):
    """Real raylet subprocesses joined to an existing GCS."""

    def __init__(self, gcs_address: tuple[str, int], config=None):
        from ray_tpu_torch.core.config import Config

        self.gcs_address = gcs_address
        self.config = config or Config.from_env()
        self._nodes: dict[str, Any] = {}
        self._types: dict[str, str] = {}

    def non_terminated_nodes(self) -> list[str]:
        return list(self._nodes)

    def node_type(self, node_id: str) -> str:
        return self._types[node_id]

    def create_node(self, node_type: NodeType) -> str:
        from ray_tpu_torch.core.node import Node

        node_id = f"local-{uuid.uuid4().hex[:8]}"
        node = Node(self.config, head=False,
                    resources=dict(node_type.resources),
                    gcs_address=self.gcs_address,
                    # The autoscaler matches cluster nodes to provider nodes
                    # through this label (scale-down identification).
                    labels={**node_type.labels,
                            "provider_node_id": node_id})
        node.start()
        self._nodes[node_id] = node
        self._types[node_id] = node_type.name
        return node_id

    def terminate_node(self, node_id: str) -> None:
        node = self._nodes.pop(node_id, None)
        self._types.pop(node_id, None)
        if node is not None:
            node.stop()

    def terminate_all(self) -> None:
        for nid in list(self._nodes):
            self.terminate_node(nid)
