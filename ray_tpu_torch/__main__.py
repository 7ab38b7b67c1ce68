"""`python -m ray_tpu_torch <command>`: the port's CLI (scripts/cli.py)."""

from ray_tpu_torch.scripts.cli import main

main()
