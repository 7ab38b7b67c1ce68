"""The port's command line (``python -m ray_tpu_torch``)."""
