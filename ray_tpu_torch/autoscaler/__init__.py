"""Autoscaler: demand-driven cluster scaling with pluggable node providers.

Counterpart of ``ray_tpu/autoscaler/__init__.py`` on the port's runtime;
importing it imports no torch.

Parity: `python/ray/autoscaler/_private/autoscaler.py:162`
(StandardAutoscaler), `resource_demand_scheduler.py:103` (bin-packing demand
→ nodes to launch), and the fake multi-node provider
(`autoscaler/_private/fake_multi_node/node_provider.py`) used to test
scaling logic with no cloud.
"""

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    LocalSubprocessProvider,
    MockProvider,
    NodeProvider,
    NodeType,
)

__all__ = ["StandardAutoscaler", "NodeProvider", "MockProvider",
           "LocalSubprocessProvider", "NodeType"]
