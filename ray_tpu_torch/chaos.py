"""Deterministic chaos injection of the PyTorch port.

The port's own copy of ``ray_tpu/chaos.py``: named fault points
("sites") in the hot paths call `hit(site)`, a no-op module-global check
unless a spec is armed. A spec is a list of rules; each targets one site
and fires a fault action on a deterministic subset of its hits:

    {"site": "llm.decode_window", "action": "raise", "after": 2}
        → the 3rd decode window this process dispatches raises
          ChaosError in the engine thread (which then fails every
          request with "engine died: ..."); other hits are untouched.

Rule fields:
    site     fault-point name (see SITES)
    action   "kill" (abrupt process exit, os._exit(137)), "raise"/"drop"
             (raise ChaosError at the site), "delay" (sleep `delay_s`)
    after    skip the first `after` hits of the site (default 0)
    count    fire on this many eligible hits, then disarm (-1 = forever)
    delay_s  sleep duration for "delay" (default 0.05)
    p        per-eligible-hit firing probability, decided by a seeded
             hash of (seed, site, hit index), not a live RNG: the same
             spec and seed fire on the same hits in every run, and on the
             same hits as the JAX package's copy (default 1.0)
    seed     hash seed for `p` (default 0)

Arming: `install(rules)` in the target process, or the environment
variable ``RAY_TPU_CHAOS='[{"site": ...}]'`` (the reference's), read once
at import; a malformed spec disarms with a warning. Hit counters are
per process.

Wired site: ``llm.decode_window``, the engine tick before the decode
window (`ray_tpu_torch.serve.llm`). The reference's other sites belong
to modules the port does not have yet; SITES keeps the reference's
names so one spec reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading

logger = logging.getLogger(__name__)

ENV_SPEC = "RAY_TPU_CHAOS"

SITES = (
    "llm.decode_window",
    "serve.replica.request",
    "serve.replica.probe",
    "serve.controller.reconcile",
    "serve.controller.ckpt_write",
    "serve.controller.enact",
    "serve.routes.push",
    "serve.kv.donate",
    "serve.kv.adopt",
)

_ACTIONS = ("kill", "raise", "drop", "delay")


class ChaosError(RuntimeError):
    """Raised at a fault point by a "raise"/"drop" rule."""


@dataclasses.dataclass
class ChaosRule:
    site: str
    action: str
    after: int = 0
    count: int = 1
    delay_s: float = 0.05
    p: float = 1.0
    seed: int = 0
    fired: int = 0  # runtime bookkeeping (per-process)

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"chaos action must be one of {_ACTIONS}, "
                             f"got {self.action!r}")


_lock = threading.Lock()
_rules: list[ChaosRule] | None = None   # None = disarmed (the fast path)
_hits: dict[str, int] = {}


def _coin(seed: int, site: str, n: int, p: float) -> bool:
    """Seeded deterministic Bernoulli draw for hit `n` of `site`."""
    if p >= 1.0:
        return True
    if p <= 0.0:
        return False
    h = hashlib.blake2b(f"{seed}:{site}:{n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64) < p


def install(spec) -> None:
    """Arm a chaos spec in THIS process. `spec` is a list of rule dicts
    (or ChaosRules), or a JSON string of one. Replaces any armed spec and
    resets hit counters."""
    global _rules
    if isinstance(spec, (str, bytes)):
        spec = json.loads(spec)
    rules = [r if isinstance(r, ChaosRule) else ChaosRule(**r)
             for r in (spec or [])]
    with _lock:
        _hits.clear()
        _rules = rules if rules else None


def uninstall() -> None:
    global _rules
    with _lock:
        _rules = None
        _hits.clear()


def active() -> bool:
    return _rules is not None


def hits(site: str) -> int:
    with _lock:
        return _hits.get(site, 0)


def hit(site: str) -> None:
    """Fault point: no-op unless a rule targets `site` and this hit is
    eligible. Actions execute HERE, in the caller's thread."""
    if _rules is None:
        return
    action = None
    delay = 0.0
    with _lock:
        if _rules is None:
            return
        n = _hits.get(site, 0)
        _hits[site] = n + 1
        for r in _rules:
            if r.site != site or n < r.after:
                continue
            if r.count >= 0 and r.fired >= r.count:
                continue
            if not _coin(r.seed, site, n, r.p):
                continue
            r.fired += 1
            action, delay = r.action, r.delay_s
            break
    if action is None:
        return
    if action == "kill":
        # SIGKILL semantics: no atexit, no finally, no stream flush — the
        # process vanishes mid-operation, exactly like an OOM-kill.
        os._exit(137)
    if action in ("raise", "drop"):
        raise ChaosError(f"chaos[{site}]: injected failure")
    if action == "delay":
        import time

        time.sleep(delay)


def _arm_from_env() -> None:
    raw = os.environ.get(ENV_SPEC)
    if not raw:
        return
    try:
        install(raw)
    except Exception as e:
        # A malformed spec silently running WITHOUT chaos would let a
        # chaos test pass vacuously — disarm explicitly and be loud.
        uninstall()
        logger.warning("malformed %s (chaos disarmed): %s", ENV_SPEC, e)


_arm_from_env()
