"""Dashboard: HTTP/JSON observability + job REST endpoints.

Parity: `dashboard/` head (state + job modules). The React
UI is out of scope; the API surface the reference's UI and `ray job` CLI
consume is served as JSON from a stdlib threaded HTTP server running inside
any client process (typically the head's CLI `start --head`):

  GET  /api/cluster_status      summary (nodes, resources, actors)
  GET  /api/nodes               node table
  GET  /api/actors              actor table
  GET  /api/memory              per-node object-store stats
  GET  /api/jobs/               job list
  POST /api/jobs/               {entrypoint, ...} → {job_id}
  GET  /api/jobs/<id>           job info
  GET  /api/jobs/<id>/logs      {logs}
  POST /api/jobs/<id>/stop      {stopped}

and /metrics, /api/logs, /api/timeline, /api/traces, /api/events,
/api/series, /api/autoscale, /api/slo and /api/serve/*. Counterpart of
``ray_tpu/dashboard.py``: every endpoint reads the port's cluster (its
``state``, ``obs_series``, ``slo`` and ``serve``), and the page's title
names the port, so a reader can tell the two dashboards apart.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch.job_submission import get_job_manager


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, obj: Any, code: int = 200) -> None:
        body = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n).decode()) if n else {}

    def do_GET(self):
        try:
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            if parsed.path in ("/", "/index.html"):
                body = _UI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parsed.path == "/api/logs":
                q = parse_qs(parsed.query)
                return self._json(state.list_logs(
                    q.get("node_id", [None])[0]))
            m = re.fullmatch(r"/api/logs/([0-9a-f]+)/([^/]+)", parsed.path)
            if m:
                q = parse_qs(parsed.query)
                tail = int(q.get("tail_bytes", ["65536"])[0])
                info = state.fetch_log(m.group(1), m.group(2), tail)
                if info is None:
                    return self._json({"error": "not found"}, 404)
                return self._json(info)
            if self.path == "/api/cluster_status":
                return self._json(state.cluster_status())
            if self.path == "/api/nodes":
                return self._json(state.list_nodes())
            if self.path == "/api/actors":
                return self._json(state.list_actors())
            if self.path == "/api/memory":
                return self._json(state.object_store_stats())
            if self.path == "/metrics":
                body = state.prometheus_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/api/timeline":
                return self._json(state.timeline())
            if parsed.path in ("/api/traces", "/api/traces/"):
                return self._json(state.list_traces())
            m = re.fullmatch(r"/api/traces/([0-9a-f]{32})", parsed.path)
            if m:
                tree = state.get_trace(m.group(1))
                if tree is None:
                    return self._json({"error": "trace not found"}, 404)
                return self._json(tree)
            if self.path == "/api/events":
                # Newest window, server-side (a post-mortem wants recent
                # events; fetching the whole ring per poll would move 10x
                # the bytes).
                return self._json(
                    state.list_cluster_events(limit=1000, tail=True))
            if self.path in ("/api/serve/applications",
                             "/api/serve/applications/"):
                # REST mirror of `serve status` (ref: the reference's
                # serve REST API, python/ray/serve/schema.py:1).
                from ray_tpu_torch.serve.schema import app_statuses

                return self._json(app_statuses())
            if self.path in ("/api/serve/load", "/api/serve/load/"):
                # Per-replica engine load (flight recorder): queue depth,
                # slot/pool fill, TTFT/decode EWMAs from each replica's
                # last stats probe — the router/autoscaler signal surface.
                from ray_tpu_torch.serve.api import CONTROLLER_NAME

                try:
                    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                except ValueError:
                    return self._json({"deployments": {}})
                return self._json({"deployments": ray_tpu_torch.get(
                    ctrl.get_load.remote(), timeout=30)})
            if parsed.path in ("/api/series", "/api/series/"):
                # Rolling metric history (GCS series store): ?name=...
                # &window_s=...&tags={"deployment":"d"} — the HTTP face
                # of state.query_series for dashboards/scrapers.
                q = parse_qs(parsed.query)
                tags = None
                if q.get("tags"):
                    tags = json.loads(q["tags"][0])
                window = q.get("window_s", [None])[0]
                return self._json({"series": state.query_series(
                    q.get("name", [None])[0], tags=tags,
                    window_s=float(window) if window else None)})
            if parsed.path in ("/api/autoscale", "/api/autoscale/"):
                # Shadow-autoscaler decision plane: per-deployment
                # recommendation + the retained decision records (inputs,
                # window aggregates, rule fired, hysteresis state) — the
                # post-hoc "why did it recommend that" surface.
                from ray_tpu_torch.serve.api import CONTROLLER_NAME

                try:
                    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                except ValueError:
                    return self._json({"mode": "off", "deployments": {}})
                return self._json(ray_tpu_torch.get(
                    ctrl.get_autoscale.remote(), timeout=30))
            if self.path in ("/api/slo", "/api/slo/"):
                # Rolling-window SLO status over the cluster histograms
                # (ray_tpu_torch/slo.py): burn rates, quantile estimates, and
                # violation flags per objective.
                return self._json(
                    {"objectives": _slo_monitor().evaluate()})
            if self.path in ("/api/jobs", "/api/jobs/"):
                return self._json(ray_tpu_torch.get(
                    self.server.jobs.list.remote(), timeout=30))
            m = re.fullmatch(r"/api/jobs/([^/]+)/logs", self.path)
            if m:
                logs = ray_tpu_torch.get(
                    self.server.jobs.logs.remote(m.group(1)), timeout=30)
                return self._json({"logs": logs})
            m = re.fullmatch(r"/api/jobs/([^/]+)", self.path)
            if m:
                info = ray_tpu_torch.get(
                    self.server.jobs.status.remote(m.group(1)), timeout=30)
                if info is None:
                    return self._json({"error": "not found"}, 404)
                return self._json(info)
            self._json({"error": "unknown endpoint"}, 404)
        except Exception as e:
            self._json({"error": repr(e)}, 500)

    def do_POST(self):
        try:
            if self.path in ("/api/jobs", "/api/jobs/"):
                b = self._body()
                job_id = ray_tpu_torch.get(self.server.jobs.submit.remote(
                    b["entrypoint"], job_id=b.get("job_id"),
                    env=b.get("env"), metadata=b.get("metadata")),
                    timeout=60)
                return self._json({"job_id": job_id})
            m = re.fullmatch(r"/api/jobs/([^/]+)/stop", self.path)
            if m:
                stopped = ray_tpu_torch.get(
                    self.server.jobs.stop.remote(m.group(1)), timeout=30)
                return self._json({"stopped": stopped})
            self._json({"error": "unknown endpoint"}, 404)
        except Exception as e:
            self._json({"error": repr(e)}, 500)

    def do_PUT(self):
        try:
            if self.path in ("/api/serve/applications",
                             "/api/serve/applications/"):
                # Declarative deploy: body is the ServeConfig dict. Replies
                # after submission (non-blocking) — poll GET for readiness.
                from ray_tpu_torch.serve.schema import ServeConfig, deploy_config

                cfg = ServeConfig.from_dict(self._body())
                out = deploy_config(cfg, blocking=False)
                return self._json({"deployed": out})
            self._json({"error": "unknown endpoint"}, 404)
        except ValueError as e:
            self._json({"error": str(e)}, 400)
        except Exception as e:
            self._json({"error": repr(e)}, 500)

    def do_DELETE(self):
        try:
            m = re.fullmatch(r"/api/serve/applications/([^/]+)", self.path)
            if m:
                from ray_tpu_torch.serve.schema import delete_app

                try:
                    deleted = delete_app(m.group(1))
                except KeyError:
                    return self._json({"error": "not found"}, 404)
                return self._json({"deleted": deleted})
            self._json({"error": "unknown endpoint"}, 404)
        except Exception as e:
            self._json({"error": repr(e)}, 500)


# One SLO monitor per dashboard process: /api/slo polls difference
# consecutive histogram snapshots, so the monitor must persist across
# requests for the rolling window to exist (first poll = lifetime view).
_slo_state: dict = {"monitor": None, "lock": threading.Lock()}


def _slo_monitor():
    with _slo_state["lock"]:
        if _slo_state["monitor"] is None:
            from ray_tpu_torch.slo import SloMonitor

            _slo_state["monitor"] = SloMonitor()
        return _slo_state["monitor"]


# Minimal single-page UI over the JSON API (the reference ships a React
# app, dashboard/client/; a build-step-free page covers the same browse
# loop: cluster summary, nodes, actors, jobs, per-node log tailing).
_UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard (PyTorch/CUDA port)</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.2rem;background:#fafafa}
 h1{font-size:1.2rem} h2{font-size:1rem;margin-top:1.4rem}
 table{border-collapse:collapse;font-size:.85rem;background:#fff}
 th,td{border:1px solid #ddd;padding:.25rem .5rem;text-align:left}
 th{background:#f0f0f0} pre{background:#111;color:#dfd;padding:.6rem;
 font-size:.75rem;max-height:24rem;overflow:auto}
 .pill{display:inline-block;padding:0 .5rem;border-radius:.6rem}
 .ok{background:#cfc}.bad{background:#fcc}
 a{cursor:pointer;color:#06c;text-decoration:underline}
</style></head><body>
<h1>ray_tpu_torch dashboard (PyTorch/CUDA port)</h1>
<div id="status"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Logs</h2><div id="logfiles"></div><pre id="logview">select a file…</pre>
<script>
const J = async p => (await fetch(p)).json();
const cell = v => typeof v==='object'? JSON.stringify(v): String(v ?? '');
function table(el, rows, cols){
  if(!rows || !rows.length){el.innerHTML='<tr><td>(none)</td></tr>';return;}
  cols = cols || Object.keys(rows[0]);
  el.innerHTML = '<tr>'+cols.map(c=>'<th>'+c+'</th>').join('')+'</tr>'+
    rows.map(r=>'<tr>'+cols.map(c=>'<td>'+cell(r[c])+'</td>').join('')+
    '</tr>').join('');
}
async function refresh(){
  const s = await J('/api/cluster_status');
  document.getElementById('status').innerHTML =
    '<span class="pill ok">'+(s.alive_nodes ?? '?')+' nodes</span> ' +
    '<span class="pill">'+cell(s.resources_total ?? s.total ?? {})+'</span>';
  table(document.getElementById('nodes'), await J('/api/nodes'),
        ['node_id','alive','address','resources_total']);
  table(document.getElementById('actors'), await J('/api/actors'),
        ['actor_id','name','state','node_id','num_restarts']);
  table(document.getElementById('jobs'), await J('/api/jobs/'));
  const logs = await J('/api/logs');
  let html='';
  for(const [node, files] of Object.entries(logs)){
    html += '<b>'+node.slice(0,8)+'</b>: ' + files.map(f =>
      '<a onclick="show(\\''+node+'\\',\\''+f.name+'\\')">'+f.name+
      '</a> ('+f.size+'B)').join(' · ') + '<br>';
  }
  document.getElementById('logfiles').innerHTML = html || '(no logs)';
}
async function show(node, name){
  const r = await J('/api/logs/'+node+'/'+name);
  document.getElementById('logview').textContent =
    r.data ?? JSON.stringify(r);
}
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.server = ThreadingHTTPServer((host, port), _Handler)
        self.server.jobs = get_job_manager()
        self.host, self.port = self.server.server_address[:2]
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="dashboard")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "Dashboard":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> Dashboard:
    """Requires an initialized ray_tpu_torch client in this process."""
    return Dashboard(host, port).start()
