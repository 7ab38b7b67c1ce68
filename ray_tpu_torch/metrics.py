"""User-facing metrics API of the PyTorch port.

    from ray_tpu_torch.metrics import Counter, Gauge, Histogram
    c = Counter("requests_total", description="...", tag_keys=("route",),
                default_tags={"app": "demo"})
    c.inc(1.0, tags={"route": "/gen"})

The contract of ``ray_tpu/metrics.py``: ``tag_keys`` declares the label
set, ``default_tags`` pre-binds values (and adds its keys), call-site
``tags`` override per observation; ``Counter.inc()`` rejects negative
values with ValueError; ``Histogram`` renders Prometheus ``_bucket``
series with cumulative ``le`` labels, ``_sum`` and ``_count``
(`ray_tpu_torch.profiling.prometheus_text` over `metrics_snapshot`).
"""

from ray_tpu_torch.profiling import Counter, Gauge, Histogram

__all__ = ["Counter", "Gauge", "Histogram"]
