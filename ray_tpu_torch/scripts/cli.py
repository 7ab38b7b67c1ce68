"""CLI: `python -m ray_tpu_torch <command>`.

Parity: `python/ray/scripts/scripts.py:2542-2586` —
start/stop/status/list/memory/submit/job. argparse instead of click (no
extra deps).

Counterpart of ``ray_tpu/scripts/cli.py``. It names only the port's
cluster: the local head is recorded in the port's own state directory
(``RAY_TPU_TORCH_STATE_DIR``, default ``~/.ray_tpu_torch``), so ``stop``
never reads or signals a head of the JAX runtime; addresses come from
``--address``, ``RAY_TPU_TORCH_ADDRESS`` or that record. ``up`` runs a
head and the port's autoscaler (``autoscaler/``: local, mock and GCP
GPU node providers) in the process until SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

def state_dir() -> str:
    """The directory of the local head's record."""
    return os.environ.get("RAY_TPU_TORCH_STATE_DIR") or os.path.expanduser(
        "~/.ray_tpu_torch")


def head_file() -> str:
    return os.path.join(state_dir(), "head.json")


def _save_head(info: dict) -> None:
    os.makedirs(state_dir(), exist_ok=True)
    with open(head_file(), "w") as f:
        json.dump(info, f)


def _load_head() -> dict | None:
    try:
        with open(head_file()) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _resolve_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    env = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if env:
        return env
    head = _load_head()
    if head:
        return head["gcs_address"]
    sys.exit("no cluster address: pass --address, set RAY_TPU_TORCH_ADDRESS, "
             "or run `start --head` on this machine first")


def cmd_start(args) -> None:
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.node import Node

    config = Config.from_env()
    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = args.num_cpus
    resources.setdefault("CPU", os.cpu_count() or 1)

    dash = None
    if args.head:
        node = Node(config, head=True, resources=resources)
        node.start()
        gcs = f"{node.gcs_address[0]}:{node.gcs_address[1]}"
        _save_head({
            "gcs_address": gcs,
            "session_dir": node.session_dir,
            "pid": os.getpid(),
        })
        print(f"head started; GCS at {gcs}", flush=True)
        print(f"attach drivers with ray_tpu_torch.init(address={gcs!r}) or "
              f"RAY_TPU_TORCH_ADDRESS={gcs}", flush=True)
        if not args.no_dashboard:
            import ray_tpu_torch

            ray_tpu_torch.init(address=gcs)
            from ray_tpu_torch.dashboard import start_dashboard

            dash = start_dashboard(port=args.dashboard_port)
            print(f"dashboard at {dash.url}", flush=True)
    else:
        addr = _resolve_address(args)
        host, port = addr.rsplit(":", 1)
        node = Node(config, head=False, resources=resources,
                    gcs_address=(host, int(port)))
        node.start()
        print(f"node started; raylet at {node.raylet_address}, "
              f"joined GCS {addr}", flush=True)

    if args.block or args.head:
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        signal.signal(signal.SIGINT, lambda *a: stop.append(1))
        try:
            while not stop:
                time.sleep(0.5)
        finally:
            # The dashboard's client first: a raylet waits for its open
            # connections before it stops.
            if dash is not None:
                import ray_tpu_torch

                dash.stop()
                ray_tpu_torch.shutdown()
            node.stop()
            if args.head:
                try:
                    os.unlink(head_file())
                except FileNotFoundError:
                    pass


def cmd_stop(args) -> None:
    head = _load_head()
    if head is None:
        sys.exit("no local head recorded")
    try:
        os.kill(head["pid"], signal.SIGTERM)
        print(f"sent SIGTERM to head pid {head['pid']}")
    except ProcessLookupError:
        print("head process already gone")
        try:
            os.unlink(head_file())
        except FileNotFoundError:
            pass


def _attach(args) -> None:
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))


def cmd_status(args) -> None:
    from ray_tpu_torch import state

    _attach(args)
    s = state.cluster_status()
    print(f"nodes: {s['nodes_alive']} alive, {s['nodes_dead']} dead")
    print(f"actors: {s['actors_alive']} alive / {s['actors_total']} total")
    print("resources:")
    for k in sorted(s["resources_total"]):
        avail = s["resources_available"].get(k, 0)
        print(f"  {k}: {avail:g}/{s['resources_total'][k]:g} available")
    if getattr(args, "serve", False):
        print(render_serve_status(history=getattr(args, "history", False)))


def _render_history(deployment: str, window_s: float) -> list[str]:
    """Sparkline block for one deployment from the GCS series store:
    summed queue depth / ongoing across replicas, max TTFT EWMA, and the
    shadow autoscaler's recommended-replica trail — metric history at a
    glance in the terminal."""
    from ray_tpu_torch import state
    from ray_tpu_torch.obs_series import resample, sparkline

    rows = (
        ("queue_depth", "serve_replica_queue_depth", "sum"),
        ("ongoing", "serve_replica_ongoing", "sum"),
        ("ttft_ewma_ms", "serve_replica_ttft_ewma_ms", "max"),
        ("kv_pages_free", "serve_replica_kv_pages_free", "sum"),
        ("recommended_replicas",
         "serve_autoscale_recommended_replicas", "max"),
    )
    out = [f"    history ({window_s:g}s):"]
    for label, metric, agg in rows:
        try:
            series = state.query_series(
                metric, tags={"deployment": deployment}, window_s=window_s)
        except Exception as e:
            return [f"    history unavailable ({e})"]
        vals = resample(series, window_s, buckets=48, agg=agg)
        if not vals:
            continue
        out.append(f"      {label:<22} {sparkline(vals)} "
                   f"min={min(vals):g} max={max(vals):g} "
                   f"last={vals[-1]:g}")
    if len(out) == 1:
        out.append("      (no series yet)")
    return out


def render_serve_status(history: bool = False,
                        history_window_s: float = 120.0) -> str:
    """`status --serve` body: per-deployment replica counts with each
    replica's live engine load (controller get_load), the shadow
    autoscaler's latest verdict, and the SLO table over the cluster
    histograms; `history=True` (the --history flag) adds series-store
    sparklines per deployment + per-SLO burn-rate trails. Factored out
    of cmd_status so tests can assert the rendering against a live
    controller without re-attaching."""
    import ray_tpu_torch
    from ray_tpu_torch import state
    from ray_tpu_torch.serve.api import CONTROLLER_NAME

    lines = ["serve:"]
    autoscale = {"mode": "off", "deployments": {}}
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        load = ray_tpu_torch.get(ctrl.get_load.remote(), timeout=30)
        try:
            autoscale = ray_tpu_torch.get(ctrl.get_autoscale.remote(), timeout=30)
        except Exception:
            # Pre-autoscaler controller still running: load view renders.
            import logging

            logging.getLogger(__name__).debug(
                "controller autoscale view unavailable", exc_info=True)
    except Exception as e:
        lines.append(f"  (no serve controller: {e})")
        load = {}
    for name, info in sorted(load.items()):
        lines.append(
            f"  {name} (route {info.get('route_prefix') or '-'}): "
            f"{len(info['replicas'])}/{info.get('num_replicas', '?')} "
            "replicas")
        for r in info["replicas"]:
            eng = r.get("load") or {}
            bits = [f"inflight={r.get('inflight', 0)}"]
            for key in ("queue_depth", "active_slots", "prefilling_slots",
                        "pool_pages_free", "pool_pages_total",
                        "prefill_budget_util", "ttft_ewma_ms",
                        "decode_tok_s_ewma", "spec_accepted_per_step",
                        # Sharding topology (tensor-parallel replicas
                        # export these; single-chip engines omit them).
                        "llm_tp", "pool_shard_bytes_used"):
                if key in eng:
                    bits.append(f"{key}={eng[key]}")
            lines.append(f"    replica {r['replica']}: " + " ".join(bits))
        a = (autoscale.get("deployments") or {}).get(name)
        if a and a.get("recommended_replicas") is not None:
            last = (a.get("decisions") or [{}])[-1]
            lines.append(
                f"    autoscale[{autoscale.get('mode')}]: "
                f"recommended={a['recommended_replicas']} "
                f"rule={last.get('rule', '-')}")
        if history:
            lines.extend(_render_history(name, history_window_s))
    try:
        from ray_tpu_torch.slo import SloMonitor

        # export=False: a one-shot read evaluates LIFETIME totals (no
        # prior snapshot to window against) — informative to print, but
        # a read-only CLI must not file slo.violation cluster events or
        # clobber the live slo_burn_rate gauges with lifetime numbers.
        statuses = SloMonitor(export=False).evaluate(
            rows=state.metrics_rows())
    except Exception as e:
        lines.append(f"  slo: unavailable ({e})")
        statuses = []
    if statuses:
        lines.append("  slo:")
        for st in statuses:
            if st["status"] == "no_data":
                lines.append(f"    {st['name']}: no data")
                continue
            mark = "VIOLATING" if st["violating"] else "ok"
            # A one-shot CLI read has no prior snapshot to window
            # against; say so instead of implying a rolling-window rate.
            span = (" over lifetime"
                    if st.get("baseline") == "lifetime" else "")
            lines.append(
                f"    {st['name']}: p{int(st['quantile'] * 100)}="
                f"{st['quantile_est_s']:.3f}s target<="
                f"{st['threshold_s']:g}s burn={st['burn_rate']:.2f} "
                f"[{mark}{span}]")
    if history:
        from ray_tpu_torch.obs_series import resample, sparkline

        try:
            series = state.query_series("slo_burn_rate",
                                        window_s=history_window_s)
        except Exception as e:
            lines.append(f"    burn history unavailable ({e})")
            series = []
        by_slo: dict[str, list] = {}
        for s in series:
            by_slo.setdefault(s["tags"].get("slo", "?"), []).append(s)
        for slo_name in sorted(by_slo):
            vals = resample(by_slo[slo_name], history_window_s,
                            buckets=48, agg="max")
            if vals:
                lines.append(f"    burn {slo_name:<17} {sparkline(vals)} "
                             f"max={max(vals):g} last={vals[-1]:g}")
    return "\n".join(lines)


def cmd_list(args) -> None:
    from ray_tpu_torch import state

    _attach(args)
    if args.kind == "nodes":
        rows = state.list_nodes()
    elif args.kind == "actors":
        rows = state.list_actors()
    elif args.kind == "tasks":
        rows = state.list_tasks()
    else:
        from ray_tpu_torch.job_submission import JobSubmissionClient

        rows = JobSubmissionClient().list_jobs()
    print(json.dumps(rows, indent=2, default=str))


def cmd_memory(args) -> None:
    from ray_tpu_torch import state

    _attach(args)
    for row in state.object_store_stats():
        print(f"node {row['node_id'][:12]}: {row['objects']} objects, "
              f"{row['shm_bytes']}/{row['capacity']} bytes shm "
              f"({row['spilled']} spilled, native={row['native_allocator']})")


def cmd_timeline(args) -> None:
    from ray_tpu_torch import state

    _attach(args)
    events = state.timeline(args.output)
    print(f"wrote {len(events)} events to {args.output}")


def cmd_debug(args) -> None:
    from ray_tpu_torch.utils import rpdb

    _attach(args)
    bps = rpdb.list_breakpoints()
    if not bps:
        print("no active breakpoints")
        return
    for i, bp in enumerate(bps):
        print(f"[{i}] {bp['function']} {bp['file']}:{bp['line']} "
              f"(pid {bp['pid']})")
    idx = int(args.index if args.index is not None else input("attach to: "))
    bp = bps[idx]
    rpdb.attach(bp["host"], bp["port"])


def cmd_up(args) -> None:
    """Blocking by design: the head node + autoscaler live in THIS process
    (Ctrl-C or SIGTERM tears the cluster down: the provider's nodes, then
    the head). For a detached cluster use `start --head` + `start
    --address`, or run `up` under a supervisor."""
    from ray_tpu_torch.autoscaler.yaml_config import up

    cluster = up(args.config)
    print(json.dumps({"address": cluster.address,
                      "cluster_name": cluster.cfg["cluster_name"]}),
          flush=True)
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.5)
    cluster.down()


def cmd_job(args) -> None:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    if args.job_cmd == "submit":
        _attach(args)
        client = JobSubmissionClient()
        import shlex

        entry = args.entrypoint
        if entry and entry[0] == "--":  # argparse.REMAINDER keeps the sep
            entry = entry[1:]
        job_id = client.submit_job(entrypoint=shlex.join(entry))
        print(job_id)
        if args.wait:
            status = client.wait_until_finished(job_id, timeout=args.timeout)
            print(client.get_job_logs(job_id), end="")
            sys.exit(0 if status == "SUCCEEDED" else 1)
    elif args.job_cmd == "status":
        _attach(args)
        print(JobSubmissionClient().get_job_status(args.job_id))
    elif args.job_cmd == "logs":
        _attach(args)
        print(JobSubmissionClient().get_job_logs(args.job_id), end="")
    elif args.job_cmd == "stop":
        _attach(args)
        print(JobSubmissionClient().stop_job(args.job_id))


def cmd_serve(args) -> None:
    """`serve deploy/status/delete/build` — the declarative ops surface
    (ref: python/ray/serve/scripts.py:1). deploy applies a
    YAML app config and reconciles removed deployments; build emits a
    config skeleton for an import path."""
    import os

    sys.path.insert(0, os.getcwd())   # resolve user import_paths like
    # `serve run` does in the reference
    if args.serve_cmd == "deploy":
        from ray_tpu_torch.serve.schema import ServeConfig, deploy_config

        cfg = ServeConfig.from_yaml_file(args.config)
        _attach(args)
        out = deploy_config(cfg, blocking=not args.no_wait,
                            timeout=args.timeout)
        print(json.dumps({"deployed": out}, indent=2))
    elif args.serve_cmd == "status":
        from ray_tpu_torch.serve.schema import app_statuses

        _attach(args)
        print(json.dumps(app_statuses(), indent=2, default=str))
    elif args.serve_cmd == "delete":
        _attach(args)
        if args.app:
            from ray_tpu_torch.serve.schema import delete_app

            print(json.dumps({"deleted": delete_app(args.name)}))
        else:
            from ray_tpu_torch import serve

            serve.delete(args.name)
            print(json.dumps({"deleted": [args.name]}))
    elif args.serve_cmd == "build":
        from ray_tpu_torch.serve.schema import _deployment_names, _import_target
        from ray_tpu_torch.serve.api import Deployment
        import yaml

        target = _import_target(args.import_path)
        if callable(target) and not isinstance(target, Deployment):
            target = target()
        skeleton = {"applications": [{
            "name": args.name or target.name,
            "import_path": args.import_path,
            "route_prefix": target.route_prefix,
            "deployments": [
                {"name": n, "num_replicas": 1}
                for n in sorted(set(_deployment_names(target)))],
        }]}
        text = yaml.safe_dump(skeleton, sort_keys=False)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            print(text, end="")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch",
        description="the PyTorch/CUDA port's cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="GCS host:port (worker nodes)")
    sp.add_argument("--num-cpus", type=int)
    sp.add_argument("--resources", help='JSON, e.g. \'{"GPU": 1}\'')
    sp.add_argument("--block", action="store_true")
    sp.add_argument("--no-dashboard", action="store_true")
    sp.add_argument("--dashboard-port", type=int, default=8265)
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the locally started head")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster summary")
    sp.add_argument("--address")
    sp.add_argument("--serve", action="store_true",
                    help="include serve deployments with per-replica "
                         "engine load and SLO burn rates")
    sp.add_argument("--history", action="store_true",
                    help="with --serve: sparkline the series-store "
                         "history (queue depth, TTFT, recommended "
                         "replicas, SLO burn) per deployment")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("kind", choices=["nodes", "actors", "tasks", "jobs"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("debug", help="list + attach to rpdb breakpoints")
    sp.add_argument("--address", default=None)
    sp.add_argument("--index", default=None)
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser(
        "up", help="start a head and its autoscaler from a cluster YAML "
                   "(blocks; SIGINT/SIGTERM tears it down)")
    sp.add_argument("config")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("memory", help="object store stats per node")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("timeline",
                        help="dump chrome-trace JSON of task execution")
    sp.add_argument("-o", "--output", default="timeline.json")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("job", help="job submission")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--address")
    j.add_argument("--wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    j = jsub.add_parser("status")
    j.add_argument("job_id")
    j.add_argument("--address")
    j = jsub.add_parser("logs")
    j.add_argument("job_id")
    j.add_argument("--address")
    j = jsub.add_parser("stop")
    j.add_argument("job_id")
    j.add_argument("--address")
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("serve", help="serve app config deploy/ops")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    s = ssub.add_parser("deploy", help="apply a YAML app config")
    s.add_argument("config")
    s.add_argument("--address")
    s.add_argument("--no-wait", action="store_true",
                   help="don't block until replicas are ready")
    s.add_argument("--timeout", type=float, default=180.0)
    s = ssub.add_parser("status", help="application + deployment status")
    s.add_argument("--address")
    s = ssub.add_parser("delete", help="delete a deployment or --app")
    s.add_argument("name")
    s.add_argument("--app", action="store_true",
                   help="treat NAME as an application (delete its whole "
                        "manifest)")
    s.add_argument("--address")
    s = ssub.add_parser("build",
                        help="emit a config skeleton for an import path")
    s.add_argument("import_path")
    s.add_argument("--name")
    s.add_argument("-o", "--output")
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
