"""Serve: model serving with replica autoscaling (Ray Serve parity).

Counterpart of ``ray_tpu/serve/``: the same exports. `LLMDeployment`
and `LLMEngine` load lazily (module ``__getattr__``), so the serve
controller, the HTTP proxy and a replica of a torch-free class, which
import this package, load no torch.
"""

from ray_tpu_torch.serve.api import (
    Deployment,
    DeploymentHandle,
    batch,
    delete,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.http_proxy import start_proxies, start_proxy

__all__ = [
    "Deployment", "DeploymentHandle", "batch", "delete", "deployment",
    "get_deployment_handle", "run", "shutdown", "start", "status",
    "start_proxy", "start_proxies", "LLMDeployment", "LLMEngine",
]


def __getattr__(name):
    if name in ("LLMDeployment", "LLMEngine"):
        from ray_tpu_torch.serve import llm

        return getattr(llm, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.serve' has no attribute {name!r}")
