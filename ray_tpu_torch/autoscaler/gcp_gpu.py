"""GCP GPU node provider.

The twin of ``ray_tpu/autoscaler/gcp_tpu.py`` (the JAX package's TPU-pod
provider) for the port's cards: a provider node is one GCE instance with
GPUs attached (`gcloud compute instances create --accelerator=...`), whose
startup script runs a raylet of the port joined to this cluster
(`python3 -m ray_tpu_torch.core.raylet --gcs host:port --resources ...
--labels ...`). Importing it imports no torch.

`NodeType.topology` keeps the reference's field name and holds the
accelerator as "<accelerator type>:<count>", e.g. "nvidia-h100-80gb:8";
a node type without one is refused. The machine type comes from the
provider config: `machine_types[<node type name>]`, else `machine_type`.

Shells out to `gcloud` (the platform CLI); the binary is injectable for
tests and the provider degrades with a clear error when it is absent.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
import uuid

from ray_tpu_torch.autoscaler.node_provider import NodeProvider, NodeType

logger = logging.getLogger(__name__)


def parse_accelerator(topology: str) -> tuple[str, int]:
    """"nvidia-h100-80gb:8" → ("nvidia-h100-80gb", 8); no count is 1."""
    kind, _, count = topology.partition(":")
    return kind, int(count or 1)


class GcpGpuProvider(NodeProvider):
    def __init__(self, provider_cfg: dict, gcs_address, *,
                 gcloud_bin: str | None = None):
        self.project = provider_cfg.get("project")
        self.zone = provider_cfg.get("zone", "us-central1-a")
        self.machine_type = provider_cfg.get("machine_type", "a3-highgpu-1g")
        self.machine_types = dict(provider_cfg.get("machine_types", {}))
        self.image_family = provider_cfg.get(
            "image_family", "common-cu128-ubuntu-2204-nvidia-570")
        self.image_project = provider_cfg.get("image_project",
                                              "deeplearning-platform-release")
        self.name_prefix = provider_cfg.get("name_prefix", "raytpu-torch")
        self.gcs_address = gcs_address
        self.gcloud = gcloud_bin or provider_cfg.get("gcloud_bin") or "gcloud"
        if shutil.which(self.gcloud) is None:
            raise RuntimeError(
                f"gcp_gpu provider needs the {self.gcloud!r} CLI on PATH")
        self._types: dict[str, str] = {}

    def _run(self, *args: str) -> str:
        cmd = [self.gcloud, "compute", "instances", *args,
               f"--zone={self.zone}"]
        if self.project:
            cmd.append(f"--project={self.project}")
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(
                f"gcloud failed ({' '.join(args[:2])}): {out.stderr[-500:]}")
        return out.stdout

    def _startup_script(self, node_type: NodeType) -> str:
        host, port = self.gcs_address
        res = json.dumps(node_type.resources)
        return (
            "python3 -m ray_tpu_torch.core.raylet "
            f"--gcs {host}:{port} --resources '{res}' "
            f"--labels '{json.dumps(node_type.labels)}'"
        )

    def non_terminated_nodes(self) -> list[str]:
        out = self._run("list", "--format=json")
        rows = json.loads(out or "[]")
        return [r["name"].rsplit("/", 1)[-1] for r in rows
                if r.get("status") not in ("STOPPING", "TERMINATED")
                and r["name"].rsplit("/", 1)[-1].startswith(self.name_prefix)]

    def node_type(self, node_id: str) -> str:
        return self._types.get(node_id, "gpu_worker")

    def create_node(self, node_type: NodeType) -> str:
        if not node_type.topology:
            raise ValueError(
                f"node type {node_type.name!r} needs `topology`, the "
                "accelerator as <type>:<count> (e.g. nvidia-h100-80gb:8)")
        kind, count = parse_accelerator(node_type.topology)
        name = f"{self.name_prefix}-{uuid.uuid4().hex[:8]}"
        self._run(
            "create", name,
            "--machine-type="
            f"{self.machine_types.get(node_type.name, self.machine_type)}",
            f"--accelerator=type={kind},count={count}",
            # GPU instances cannot live-migrate.
            "--maintenance-policy=TERMINATE",
            f"--image-family={self.image_family}",
            f"--image-project={self.image_project}",
            # ^|^ alternate-delimiter syntax: the startup script embeds
            # JSON commas, which gcloud would otherwise split into bogus
            # key=value pairs.
            "--metadata",
            f"^|^startup-script={self._startup_script(node_type)}",
        )
        self._types[name] = node_type.name
        logger.info("created GPU instance %s (%s x%d)", name, kind, count)
        return name

    def terminate_node(self, node_id: str) -> None:
        self._run("delete", node_id, "--quiet")
        self._types.pop(node_id, None)

    def is_ready(self, node_id: str) -> bool:
        out = self._run("describe", node_id, "--format=json")
        return json.loads(out).get("status") == "RUNNING"
