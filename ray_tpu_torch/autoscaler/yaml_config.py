"""Declarative cluster YAML + `up`/`down` (ref: autoscaler/ray-schema.json,
`ray up`).

Counterpart of ``ray_tpu/autoscaler/yaml_config.py`` on the port's runtime;
importing it imports no torch (nor yaml: `load_cluster_config` imports
pyyaml when called and raises `ImportError` naming it without). The
provider types are `local`, `mock` and `gcp_gpu` (the GPU node provider
in the place of the reference's `gcp_tpu`, which raises here). Minimal
schema:

```yaml
cluster_name: my-cluster
provider:
  type: local          # local | mock | gcp_gpu
  # gcp_gpu extras: project, zone, machine_type (default a3-highgpu-1g),
  # machine_types ({node type: machine type}), image_family,
  # image_project, name_prefix
max_workers: 8
node_types:
  cpu_worker:
    resources: {CPU: 4}
    min_workers: 1
    max_workers: 4
  gpu_worker:
    resources: {CPU: 8, GPU: 1}
    topology: nvidia-h100-80gb:1   # accelerator type:count of one VM
    min_workers: 0
    max_workers: 2
```

`up(path)` starts a head node (GCS + raylet), instantiates the provider, and
runs a StandardAutoscaler reconcile thread honoring min/max workers;
`down()` terminates provider nodes and the head.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    LocalSubprocessProvider,
    MockProvider,
    NodeProvider,
    NodeType,
)

logger = logging.getLogger(__name__)


def load_cluster_config(path: str) -> dict:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "load_cluster_config reads YAML and needs pyyaml "
            "(pip install pyyaml)") from e

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict) or "node_types" not in cfg:
        raise ValueError(f"{path}: expected a mapping with 'node_types'")
    cfg.setdefault("provider", {"type": "local"})
    cfg.setdefault("cluster_name", "ray-tpu-cluster")
    return cfg


def parse_node_types(cfg: dict) -> list[NodeType]:
    out = []
    for name, nt in cfg["node_types"].items():
        out.append(NodeType(
            name=name,
            resources=dict(nt.get("resources", {"CPU": 1})),
            min_workers=int(nt.get("min_workers", 0)),
            max_workers=int(nt.get("max_workers",
                                   cfg.get("max_workers", 10))),
            labels=dict(nt.get("labels", {})),
            topology=nt.get("topology"),
        ))
    return out


def make_provider(cfg: dict, gcs_address) -> NodeProvider:
    ptype = cfg["provider"].get("type", "local")
    if ptype == "mock":
        return MockProvider()
    if ptype == "local":
        return LocalSubprocessProvider(gcs_address)
    if ptype == "gcp_gpu":
        from ray_tpu_torch.autoscaler.gcp_gpu import GcpGpuProvider

        return GcpGpuProvider(cfg["provider"], gcs_address)
    if ptype == "gcp_tpu":
        raise ValueError(
            "provider type 'gcp_tpu' is the JAX package's TPU-pod provider;"
            " the port provides GPU nodes: use 'gcp_gpu'")
    raise ValueError(f"unknown provider type {ptype!r}")


class ClusterUp:
    """`ray up` equivalent: head + provider + autoscaler loop in-process."""

    def __init__(self, config_path: str, *, update_interval_s: float = 2.0):
        from ray_tpu_torch.core.config import Config
        from ray_tpu_torch.core.node import Node

        self.cfg = load_cluster_config(config_path)
        node_types = parse_node_types(self.cfg)  # validate before any spawn
        self.head = Node(Config.from_env(), head=True,
                         resources=dict(self.cfg.get(
                             "head_resources", {"CPU": 2})))
        self.head.start()
        try:
            self.provider = make_provider(self.cfg, self.head.gcs_address)
            self.autoscaler = StandardAutoscaler(
                self.provider, node_types,
                gcs_address=self.head.gcs_address,
            )
        except BaseException:
            # Don't leak a running head with no handle to stop it.
            self.head.stop()
            raise
        self._stop = threading.Event()
        self._interval = update_interval_s
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        host, port = self.head.gcs_address
        return f"{host}:{port}"

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:
                logger.exception("autoscaler reconcile failed")
            self._stop.wait(self._interval)

    def down(self):
        self._stop.set()
        self._thread.join(timeout=10)
        term = getattr(self.provider, "terminate_all", None)
        if term is not None:
            term()
        else:
            for nid in self.provider.non_terminated_nodes():
                self.provider.terminate_node(nid)
        self.head.stop()


def up(config_path: str) -> ClusterUp:
    return ClusterUp(config_path)
