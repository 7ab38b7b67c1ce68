"""Remote pdb for tasks/actors (ref: `python/ray/util/
rpdb.py` + `ray debug`, scripts.py:206).

`ray_tpu_torch.utils.rpdb.set_trace()` inside remote code opens a TCP pdb
session and registers the endpoint in the GCS KV (namespace "debugger")
so `python -m ray_tpu_torch debug` can list active breakpoints and
attach. Execution blocks until a debugger connects (or `timeout_s`
elapses, then continues). Counterpart of ``ray_tpu/utils/rpdb.py``; the
cross-node opt-in is ``RAY_TPU_TORCH_DEBUGGER_EXTERNAL``.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time


class _SocketIO:
    """File-like adapter pdb can use as stdin/stdout."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._rfile = sock.makefile("r", encoding="utf-8", newline="\n")
        self._wfile = sock.makefile("w", encoding="utf-8", newline="\n")

    def readline(self):
        return self._rfile.readline()

    def write(self, s):
        self._wfile.write(s)
        return len(s)

    def flush(self):
        try:
            self._wfile.flush()
        except (BrokenPipeError, OSError):
            pass

    def close(self):
        for f in (self._rfile, self._wfile, self._sock):
            try:
                f.close()
            except OSError:
                pass


def _kv():
    from ray_tpu_torch import api

    return api._ensure_client()


def _routable_ip(client) -> str:
    """This node's cluster-routable address: the local endpoint of the GCS
    connection (loopback would send multi-node attachers to themselves)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect((client.gcs_address[0], client.gcs_address[1] or 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


def set_trace(timeout_s: float = 300.0):
    """Breakpoint: block for a `ray_tpu_torch debug` attach, then drop into pdb
    over the connection. Continues silently if nobody attaches in time.

    Binds to 127.0.0.1 by default — an open pdb socket is arbitrary code
    execution, so cross-node attach (routable-IP bind) requires the explicit
    `RAY_TPU_TORCH_DEBUGGER_EXTERNAL=1` opt-in (attach via SSH tunnel otherwise),
    mirroring the reference's --ray-debugger-external flag.
    """
    import pdb

    client = _kv()
    if os.environ.get("RAY_TPU_TORCH_DEBUGGER_EXTERNAL") == "1":
        bind_ip = _routable_ip(client)
    else:
        bind_ip = "127.0.0.1"
    srv = socket.socket()
    srv.bind((bind_ip, 0))
    srv.listen(1)
    srv.settimeout(timeout_s)
    host, port = srv.getsockname()
    key = f"{os.getpid()}:{port}".encode()
    frame = sys._getframe(1)
    info = {
        "host": host, "port": port, "pid": os.getpid(),
        "function": frame.f_code.co_name,
        "file": frame.f_code.co_filename, "line": frame.f_lineno,
        "ts": time.time(),
    }
    client.kv_put("debugger", key, json.dumps(info).encode())
    try:
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            return  # nobody attached; continue execution
        io = _SocketIO(conn)
        io.write(f"ray_tpu_torch rpdb @ {info['function']} "
                 f"({info['file']}:{info['line']})\n")
        io.flush()
        dbg = pdb.Pdb(stdin=io, stdout=io)
        dbg.use_rawinput = False
        dbg.set_trace(frame)
    finally:
        try:
            client._run(client.gcs.call(
                "kv_del", {"ns": "debugger", "key": key}))
        except Exception:  # graftlint: disable=EXC-SWALLOW (the entry ages out in list_breakpoints)
            pass
        srv.close()


def list_breakpoints(stale_after_s: float = 3600.0) -> list[dict]:
    """Active breakpoints. Entries from workers that died uncleanly (a
    SIGKILLed worker can't clean its KV entry) age out after
    `stale_after_s` and are removed on listing."""
    client = _kv()
    keys = client._run(client.gcs.call(
        "kv_keys", {"ns": "debugger", "prefix": b""}))
    out = []
    now = time.time()
    for k in keys:
        raw = client.kv_get("debugger", k)
        if not raw:
            continue
        bp = json.loads(raw)
        if now - bp.get("ts", 0) > stale_after_s:
            client._run(client.gcs.call(
                "kv_del", {"ns": "debugger", "key": k}))
            continue
        out.append(bp)
    return out


def attach(host: str, port: int, *, stdin=None, stdout=None) -> None:
    """Interactive attach: bridge local stdio to the remote pdb socket."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    sock = socket.create_connection((host, port), timeout=30)
    try:
        import threading

        def pump_out():
            # Byte-wise pump: the "(Pdb) " prompt has no trailing newline,
            # so line iteration would never display it.
            while True:
                try:
                    data = sock.recv(4096)
                except OSError:
                    return
                if not data:
                    return
                stdout.write(data.decode("utf-8", "replace"))
                stdout.flush()

        t = threading.Thread(target=pump_out, daemon=True)
        t.start()
        for line in stdin:
            try:
                sock.sendall(line.encode())
            except (BrokenPipeError, OSError):
                break
            if line.strip() in ("c", "continue", "q", "quit"):
                break
        t.join(timeout=2)
    finally:
        sock.close()
