"""Chaos bench of the PyTorch/CUDA port: zero-drop serving under a
replica kill and a scale-down drain.

The twin of ``bench_chaos.py`` on ``ray_tpu_torch``'s serve plane (drain
protocol + cross-replica decode failover + chaos harness):

    N concurrent SSE streams run against a multi-replica LLMDeployment
    through the async HTTP proxy while (a) one serving replica is killed
    mid-decode (a counter-based ``llm.decode_window`` chaos rule inside
    the victim process) and (b) one replica is drained away by a
    scale-down. Every stream must end in [DONE] with EXACTLY the token
    sequence an uninterrupted in-process run of the same seeded workload
    produces: zero dropped requests, zero duplicated or missing tokens.
    The row records the failover latency clients saw (the largest gap
    between two tokens of a stream) and the proxy's failover count
    (``serve_failovers_total``), which shows the kill was not vacuous.

Run (the replicas and the baseline serve on the card; ``--device cpu``
runs them on the CPU):

    python bench_chaos_torch.py [--clients 32] [--replicas 3] [--device cpu]

Prints one JSON line:
  {"metric": "serve_chaos", "clients": N, "dropped": 0,
   "mismatched_streams": 0, "failovers": ..., "failover_gap_ms_max": ...}

``tests/test_torch_chaos.py::TestZeroDrop`` runs this scenario through
``run_scenario()`` on the CPU and holds its streams to the JAX package's
engine; ``chip_smoke.py``'s ``serve_chaos`` part runs it on the card.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time

import numpy as np

ROUTE, NAME = "/llm", "llmchaos"   # the reference's route and deployment


def _sse_stream(port: int, route: str, payload: dict,
                timeout_s: float = 300.0) -> dict:
    """One SSE client: POST `payload` (+stream) to the proxy, collect
    tokens with arrival timestamps until [DONE]/error/EOF."""
    body = json.dumps(dict(payload, stream=True)).encode()
    req = (b"POST " + route.encode() + b" HTTP/1.1\r\nHost: x\r\n"
           b"Content-Type: application/json\r\n"
           b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
           + body)
    tokens: list[int] = []
    arrivals: list[float] = []
    done = False
    error = None
    try:
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=timeout_s) as s:
            s.sendall(req)
            s.settimeout(timeout_s)
            buf = b""
            # Consume the HTTP response head first: it would otherwise
            # glue onto the first SSE event and swallow its token.
            while b"\r\n\r\n" not in buf:
                data = s.recv(65536)
                if not data:
                    return {"tokens": [], "arrivals": [], "done": False,
                            "error": "connection closed before headers"}
                buf += data
            buf = buf.split(b"\r\n\r\n", 1)[1]
            while True:
                idx = buf.find(b"\n\n")
                if idx < 0:
                    data = s.recv(65536)
                    if not data:
                        break
                    buf += data
                    continue
                event, buf = buf[:idx], buf[idx + 2:]
                line = event.strip()
                if not line.startswith(b"data: "):
                    continue
                data = line[len(b"data: "):]
                if data == b"[DONE]":
                    done = True
                    break
                obj = json.loads(data)
                if "token" in obj:
                    tokens.append(int(obj["token"]))
                    arrivals.append(time.perf_counter())
                elif "error" in obj:
                    error = obj["error"]
                    break
    except Exception as e:  # noqa: BLE001 — a client-side failure IS a drop
        error = f"client: {e!r}"
    return {"tokens": tokens, "arrivals": arrivals, "done": done,
            "error": error}


def _pctl(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(len(s) * q))]


def _prompts(vocab: int, clients: int, prompt_len, seed: int) -> list:
    """Seeded prompts: ``prompt_len`` tokens each, or a length drawn from
    [lo, hi] per prompt when it is a pair."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(clients):
        n = (prompt_len if isinstance(prompt_len, int)
             else int(rng.integers(prompt_len[0], prompt_len[1] + 1)))
        out.append([int(t) for t in rng.integers(0, vocab, n)])
    return out


def _replica_call(rt, h, method, *args, **kwargs):
    return rt.get(h.handle_request.remote(method, args, kwargs),
                  timeout=120)


def _failovers(route: str) -> dict:
    """The proxy's ``serve_failovers_total`` for ``route`` by mode, as the
    GCS holds it (every process pushes its metrics there each second)."""
    from ray_tpu_torch import state

    out: dict = {}
    for r in state.metrics_rows():
        if (r["name"] == "serve_failovers_total"
                and r["tags"].get("route") == route):
            mode = r["tags"].get("mode", "")
            out[mode] = out.get(mode, 0.0) + r["value"]
    return out


def run_scenario(*, clients: int = 32, replicas: int = 3,
                 scale_down_to: int = 2, max_tokens: int = 12,
                 prompt_len=12, n_slots: int = 4, max_len: int = 96,
                 kill_after_windows: int = 8, drain_timeout_s: float = 2.0,
                 kill_delay_s: float = 0.3, drain_delay_s: float = 0.8,
                 prefill_chunk: int = 8, seed: int = 0,
                 keep_cluster: bool = False, model="tiny",
                 params_checkpoint: str | None = None, device=None,
                 engine_kwargs: dict | None = None,
                 replica_gpus: float | None = None,
                 detail: dict | None = None) -> dict:
    """Build the cluster (or use the one this process is attached to),
    run the seeded chaos workload, return the row.

    Deterministic inputs: prompts come from `seed`, the replica kill is a
    counter-based chaos rule (the Nth decode window of the victim
    process), greedy decoding makes the expected token streams a pure
    function of the prompts and the weights, so the exactness check is a
    strict equality against an uninterrupted in-process baseline of the
    same workload on the same weights.

    ``model``: a preset name or a ``GPTConfig``. ``params_checkpoint``: a
    ``Checkpoint`` directory whose ``"params"`` the baseline engine and
    every replica load (None: each inits its weights from seed 0, as the
    reference's). ``device``: where the baseline and the replicas serve,
    None the card (raises without one), ``"cpu"`` for tests.
    ``prompt_len``: tokens per prompt, or a ``(lo, hi)`` range drawn per
    prompt. ``engine_kwargs``: the engines' knobs (default the
    reference's paged chunked engine). ``replica_gpus``: each replica's
    ``num_gpus``. ``detail``, when given, receives the prompts, the
    expected and served streams and each replica's record (kernel
    launches, decode steps, its load when the scale-down began).
    """
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve.api import _get_controller
    from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

    cfg = gpt.GPTConfig.by_name(model) if isinstance(model, str) else model
    prompts = _prompts(cfg.vocab_size, clients, prompt_len, seed)
    if engine_kwargs is None:
        engine_kwargs = {"prefill_buckets": (16, 32),
                         "kv_mode": "paged", "page_size": 16,
                         "prefill_chunk": prefill_chunk,
                         "prefill_token_budget": max(prefill_chunk,
                                                     n_slots * prefill_chunk)}
    params = None
    if params_checkpoint:
        from ray_tpu_torch.train.checkpoint import Checkpoint

        params = Checkpoint.from_directory(params_checkpoint).to_dict()[
            "params"]

    owned = not rt.is_initialized()
    if owned:
        rt.init(num_cpus=4, _system_config={
            "serve_drain_timeout_s": drain_timeout_s})
    row: dict = {"metric": "serve_chaos", "clients": clients,
                 "replicas": replicas, "scale_down_to": scale_down_to,
                 "max_tokens": max_tokens, "prompt_len": prompt_len,
                 "drain_timeout_s": drain_timeout_s, "seed": seed}
    try:
        options = {"num_replicas": replicas, "route_prefix": ROUTE}
        if replica_gpus is not None:
            options["ray_actor_options"] = {"num_gpus": replica_gpus}
        dep = serve.deployment(LLMDeployment, name=NAME).options(
            **options).bind(
            model, n_slots=n_slots, max_len=max_len, device=device,
            params_checkpoint=params_checkpoint,
            engine_kwargs=dict(engine_kwargs))
        # The replicas boot while this process runs the baseline.
        t0 = time.perf_counter()
        serve.run(dep, _blocking_until_ready=False, timeout=600.0)

        # --- uninterrupted baseline: the exact greedy streams the chaos
        # run must reproduce (the replicas' model, weights and knobs).
        base_engine = LLMEngine(cfg, params, n_slots=n_slots,
                                max_len=max_len, device=device,
                                **engine_kwargs)
        expected = []
        for p in prompts:
            req = base_engine.submit(p, max_tokens=max_tokens)
            while not req.done.is_set():
                base_engine.step()
            if req.error:
                raise RuntimeError(f"baseline request failed: {req.error}")
            expected.append(list(req.out_ids))
        del base_engine, params
        row["baseline_s"] = round(time.perf_counter() - t0, 3)
        handle = serve.run(dep, timeout=600.0)
        row["boot_s"] = round(time.perf_counter() - t0, 3)
        _proxy, port = serve.start_proxy()
        time.sleep(1.0)  # route table refresh

        # Warm every replica before the chaos phase so the measured gaps
        # are failover latency, not first-call work.
        for _ in range(replicas * 3):
            rt.get(handle.method("generate", prompts[0], max_tokens=2),
                   timeout=600)

        # Victim selection + seeded kill: the FIRST routable replica gets
        # a counter-based decode-window kill rule; the process exits
        # abruptly (os._exit) with streams mid-decode.
        ctrl = _get_controller()
        table = rt.get(ctrl.get_routing.remote(-1), timeout=30)
        victims = table["routes"][NAME]["replicas"]
        assert len(victims) == replicas
        aid = lambda h: h._actor_id.hex()
        reps = {aid(h): {"before": _replica_call(rt, h, "metrics")}
                for h in victims}
        for h in victims:
            _replica_call(rt, h, "kernel_launches", reset=True)
        failovers0 = _failovers(NAME)

        results: list[dict | None] = [None] * clients
        t0 = time.perf_counter()

        def client(i: int):
            results[i] = _sse_stream(port, ROUTE, {
                "prompt_ids": prompts[i], "max_tokens": max_tokens},
                timeout_s=600.0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        time.sleep(kill_delay_s)
        reps[aid(victims[0])]["at_install"] = _replica_call(
            rt, victims[0], "metrics")
        kill_at = time.perf_counter() - t0
        rt.get(victims[0].install_chaos.remote(
            [{"site": "llm.decode_window", "action": "kill",
              "after": kill_after_windows, "seed": seed}]), timeout=30)
        time.sleep(max(0.0, drain_delay_s - kill_delay_s))
        # Each replica's load as the scale-down begins (the victim's
        # answer is lost once it has died).
        for h in victims:
            try:
                reps[aid(h)]["load_at_drain"] = rt.get(
                    h.handle_request.remote("load_snapshot", (), {}),
                    timeout=10)
            except Exception as e:  # noqa: BLE001 — the killed replica
                reps[aid(h)]["load_at_drain"] = {"error": repr(e)}
        drain_at = time.perf_counter() - t0
        # Scale-down mid-burst: same config, fewer replicas → the
        # controller resizes in place and sheds the excess replica
        # through the drain protocol (never a hard kill before
        # serve_drain_timeout_s).
        serve.run(dep.options(num_replicas=scale_down_to), timeout=600.0)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

        dropped = sum(1 for r in results
                      if r is None or r["error"] or not r["done"])
        mismatched = sum(1 for r, exp in zip(results, expected)
                         if r is not None and r["tokens"] != exp)
        gaps = []
        for r in results:
            if r and len(r["arrivals"]) > 1:
                a = r["arrivals"]
                gaps.append(max(b - c for b, c in zip(a[1:], a)))
        # Wait out the drain window so the final replica count reflects
        # the reaped state (and the routing table no longer holds the
        # killed replica), then snapshot it.
        killed = aid(victims[0])
        deadline = time.time() + drain_timeout_s + 30
        while True:
            status = serve.status()[NAME]
            final = rt.get(ctrl.get_routing.remote(-1), timeout=30)[
                "routes"][NAME]["replicas"]
            settled = (not status["draining_replicas"]
                       and status["live_replicas"] == scale_down_to
                       and killed not in {aid(h) for h in final})
            if settled or time.time() > deadline:
                break
            time.sleep(0.5)
        for h in final:
            rec = reps.setdefault(aid(h), {})
            try:
                rec["launches"] = _replica_call(rt, h, "kernel_launches")
                rec["after"] = _replica_call(rt, h, "metrics")
                rec["page_accounting"] = _replica_call(rt, h,
                                                       "page_accounting")
            except Exception as e:  # noqa: BLE001 — reported, a gate
                rec["error"] = repr(e)
        survivors = {aid(h) for h in final}
        drained = [a for a in reps if a not in survivors and a != killed
                   and "before" in reps[a]]
        time.sleep(1.5)   # one metrics push of the proxy past the last
        failovers = {m: v - failovers0.get(m, 0.0)
                     for m, v in _failovers(NAME).items()}
        row.update({
            "dropped": dropped,
            "mismatched_streams": mismatched,
            "completed": sum(1 for r in results if r and r["done"]),
            "tokens_expected": sum(len(e) for e in expected),
            "tokens_received": sum(len(r["tokens"])
                                   for r in results if r),
            "kill_at_s": round(kill_at, 3),
            "drain_at_s": round(drain_at, 3),
            "wall_s": round(wall, 2),
            # Max inter-token gap per stream: streams that crossed the
            # kill/drain paid one failover (re-pick + teacher-forced
            # re-prefill) inside this gap.
            "failover_gap_ms_p50": round(_pctl(gaps, 0.50) * 1000, 1),
            "failover_gap_ms_p95": round(_pctl(gaps, 0.95) * 1000, 1),
            "failover_gap_ms_max": round(max(gaps) * 1000, 1)
            if gaps else 0.0,
            "final_live_replicas": status["live_replicas"],
            "final_draining_replicas": status["draining_replicas"],
            "serve_failovers_total": sum(failovers.values()),
            "failovers_by_mode": failovers,
            # The victim's decode windows before its rule was armed.
            "victim_windows_at_install": (
                reps[killed]["at_install"]["decode_windows"]
                - reps[killed]["before"]["decode_windows"]),
            "killed_replica": killed[:12],
            "drained_replicas": [a[:12] for a in drained],
        })
        if detail is not None:
            detail.update({
                "prompts": prompts, "expected": expected,
                "streams": [r["tokens"] if r else None for r in results],
                "errors": [r["error"] if r else "no result"
                           for r in results],
                "replicas": reps, "killed": killed, "drained": drained,
                "survivors": sorted(survivors)})
        return row
    finally:
        if owned and not keep_cluster:
            serve.shutdown()
            rt.shutdown()
        elif rt.is_initialized():
            serve.delete(NAME)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--scale-down-to", type=int, default=2)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--kill-after-windows", type=int, default=8)
    ap.add_argument("--drain-timeout", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--params-checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="the replicas' and the baseline's device: the "
                         "card by default, 'cpu' for a CPU run")
    ap.add_argument("--replica-gpus", type=float, default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    row = run_scenario(
        clients=args.clients, replicas=args.replicas,
        scale_down_to=args.scale_down_to, max_tokens=args.max_tokens,
        prompt_len=args.prompt_len, n_slots=args.n_slots,
        kill_after_windows=args.kill_after_windows,
        drain_timeout_s=args.drain_timeout, seed=args.seed,
        model=args.model, params_checkpoint=args.params_checkpoint,
        device=args.device, replica_gpus=args.replica_gpus)
    print(json.dumps(row), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(row, f)


if __name__ == "__main__":
    main()
