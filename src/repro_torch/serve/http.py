"""A dependency-free HTTP/JSON front end over the SessionManager.

The port's counterpart of ``repro.serve.http``, speaking its protocol:
the same endpoints, bodies, status codes and NDJSON stream lines, so
either package's :class:`ServeClient` drives either server.  Stdlib only
(``http.server`` and ``urllib``).

Endpoints::

    GET  /healthz                     liveness
    GET  /stats                       sessions + counted-cache counters
    GET  /sessions                    session listing
    POST /sessions                    {"experiment": {...}} |
                                      {"scenario_path": "..."} [, "seed",
                                      "session_id"] -> {"id": ...}
    POST /sessions/<id>/run           {"t_ms": .., "chunk_ms": ..} ->
                                      NDJSON stream: one line per chunk
                                      (population spike totals, rtf,
                                      stream-probe summaries), then a
                                      final summary
    POST /sessions/<id>/suspend       -> {"checkpoint": path}
    POST /sessions/<id>/resume        -> {"ok": true}
    POST /run_many                    {"requests": {id: t_ms}, "coalesce"}
    DELETE /sessions/<id>             destroy
    POST /shutdown                    stop serving (in-process control)

Status codes: 404 for an unknown route or session, 400 for a malformed
request or a session in the wrong state, 500 (with the message) for any
other failure, a kernel's build or launch included.  A failure after a
stream's headers went out is an in-band ``{"error": ...}`` line.

Run it on the card::

    PYTHONPATH=src python -m repro_torch.serve --port 8642

Each request is served on its own thread.  ``/healthz``, ``/stats`` and
``/sessions`` read host state only, so they answer while another request
builds a backend or captures a graph; every request that touches the
device waits for the manager's lock.
"""
from __future__ import annotations

import json
import re
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib import request as _urlrequest

import numpy as np

from repro_torch.core.delivery import DeliveryOverflowError
from repro_torch.serve.session import SessionManager, SessionStateError

_SESSION_OP = re.compile(r"^/sessions/([^/]+)(?:/(run|suspend|resume))?$")
# the caller's errors (400); any other exception is the server's (500)
_CLIENT_ERRORS = (ValueError, TypeError, SessionStateError,
                  DeliveryOverflowError)


def _chunk_snapshot(i: int, res) -> Dict[str, Any]:
    """The per-chunk streaming payload: small, JSON-safe reductions."""
    out: Dict[str, Any] = {
        "chunk": int(i),
        "t_model_ms": float(res.t_model_ms),
        "rtf": float(res.rtf),
        "overflow": int(res.overflow),
    }
    if "pop_counts" in res.data:
        out["pop_spikes"] = np.asarray(res.data["pop_counts"]) \
            .sum(axis=0).astype(int).tolist()
    # stream-probe snapshots: a dict carry ships its leaves, scalars as
    # numbers and arrays as {"shape", "sum"}; any other carry (the
    # spike_stats NamedTuple) ships no leaves, as the reference's does
    for name, snap in res.streams.items():
        carry = snap["carry"]
        leaves = {}
        for k, v in carry.items() if isinstance(carry, dict) else []:
            arr = np.asarray(v)
            leaves[k] = (float(arr) if arr.ndim == 0
                         else {"shape": list(arr.shape),
                               "sum": float(arr.sum())})
        out.setdefault("streams", {})[name] = leaves
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-torch-serve/1"
    manager: SessionManager = None          # set by SimServer
    quiet = True

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):      # noqa: A003 - stdlib name
        if not self.quiet:
            super().log_message(fmt, *args)

    def _body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        body = json.loads(self.rfile.read(n) or b"{}")
        if not isinstance(body, dict):
            raise ValueError("the body must be a JSON object")
        return body

    def _json(self, obj: Any, status: int = 200) -> None:
        blob = (json.dumps(obj) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _error(self, status: int, message: str) -> None:
        self._json({"error": message}, status=status)

    # -- streaming ----------------------------------------------------------

    def _start_stream(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _stream_line(self, obj: Any) -> None:
        blob = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(blob):x}\r\n".encode() + blob + b"\r\n")
        self.wfile.flush()

    def _end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # -- routes -------------------------------------------------------------

    def do_GET(self):                       # noqa: N802 - stdlib casing
        if self.path == "/healthz":
            return self._json({"ok": True})
        if self.path == "/stats":
            return self._json(self.manager.stats())
        if self.path == "/sessions":
            return self._json({"sessions": self.manager.sessions()})
        self._error(404, f"no route GET {self.path}")

    def do_DELETE(self):                    # noqa: N802
        m = _SESSION_OP.match(self.path)
        if m and m.group(2) is None:
            try:
                self.manager.destroy(m.group(1))
            except KeyError as e:
                return self._error(404, str(e))
            return self._json({"ok": True})
        self._error(404, f"no route DELETE {self.path}")

    def do_POST(self):                      # noqa: N802
        try:
            body = self._body()
        except ValueError as e:     # json.JSONDecodeError is a ValueError
            return self._error(400, f"bad JSON body: {e}")
        try:
            return self._route_post(body)
        except KeyError as e:
            return self._error(404, str(e))
        except _CLIENT_ERRORS as e:
            return self._error(400, f"{type(e).__name__}: {e}")
        except Exception as e:             # the server's fault: report it
            traceback.print_exc(file=sys.stderr)
            return self._error(500, f"{type(e).__name__}: {e}")

    def _route_post(self, body: Dict[str, Any]):
        if self.path == "/shutdown":
            self._json({"ok": True})
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return
        if self.path == "/sessions":
            spec = body.get("experiment") or body.get("scenario_path")
            if spec is None:
                return self._error(
                    400, "pass 'experiment' (a scenario document) or "
                         "'scenario_path'")
            session = self.manager.create(
                spec, session_id=body.get("session_id"),
                seed=body.get("seed"))
            return self._json({"id": session.id, **session.info()},
                              status=201)
        if self.path == "/run_many":
            out = self.manager.run_many(
                {k: float(v) for k, v in body["requests"].items()},
                coalesce=bool(body.get("coalesce", True)))
            return self._json({
                sid: _chunk_snapshot(1, res) for sid, res in out.items()})
        m = _SESSION_OP.match(self.path)
        if m is None:
            return self._error(404, f"no route POST {self.path}")
        sid, op = m.group(1), m.group(2)
        if op == "suspend":
            return self._json({"checkpoint": self.manager.suspend(sid)})
        if op == "resume":
            self.manager.resume(sid)
            return self._json({"ok": True})
        if op == "run":
            return self._run_streaming(sid, body)
        return self._error(404, f"no route POST {self.path}")

    def _run_streaming(self, sid: str, body: Dict[str, Any]):
        t_ms = float(body.get("t_ms", 100.0))
        chunk_ms = body.get("chunk_ms")
        chunk_ms = float(chunk_ms) if chunk_ms else None
        session = self.manager.get(sid)
        self._start_stream()

        def per_chunk(i, res):
            self._stream_line(_chunk_snapshot(i, res))

        try:
            res = self.manager.run(sid, t_ms, chunk_ms=chunk_ms,
                                   callback=per_chunk)
            self._stream_line({
                "done": True, "id": sid,
                "t_model_ms": float(res.t_model_ms),
                "rtf": float(res.rtf),
                "wall_s": float(res.wall_s),
                "overflow": int(res.overflow),
                "session_t_model_ms": session.t_model_ms,
            })
        except Exception as e:             # surface in-band: headers sent
            if not isinstance(e, _CLIENT_ERRORS):
                traceback.print_exc(file=sys.stderr)
            self._stream_line({"error": f"{type(e).__name__}: {e}"})
        self._end_stream()


class SimServer:
    """The session server: a ThreadingHTTPServer bound to a manager.

    ``manager=None`` makes a ``SessionManager()`` on the card (it raises
    without one).  ``port=0`` binds an ephemeral port (``server.port``
    tells which).  ``serve_forever`` blocks; ``start()`` serves on a
    daemon thread, for use in one process.
    """

    def __init__(self, manager: Optional[SessionManager] = None,
                 host: str = "127.0.0.1", port: int = 8642,
                 quiet: bool = True):
        self.manager = manager or SessionManager()
        handler = type("BoundHandler", (_Handler,),
                       {"manager": self.manager, "quiet": quiet})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "SimServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.manager.close()


class ServeClient:
    """Minimal stdlib client for :class:`SimServer`."""

    def __init__(self, url: str, timeout: float = 300.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _req(self, method: str, path: str, body: Optional[dict] = None):
        data = None if body is None else json.dumps(body).encode()
        req = _urlrequest.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        return _urlrequest.urlopen(req, timeout=self.timeout)

    def _json(self, method: str, path: str, body: Optional[dict] = None):
        with self._req(method, path, body) as resp:
            return json.loads(resp.read())

    # -- API ----------------------------------------------------------------

    def healthz(self) -> dict:
        return self._json("GET", "/healthz")

    def stats(self) -> dict:
        return self._json("GET", "/stats")

    def sessions(self) -> list:
        return self._json("GET", "/sessions")["sessions"]

    def create(self, experiment: Optional[dict] = None,
               scenario_path: Optional[str] = None,
               seed: Optional[int] = None,
               session_id: Optional[str] = None) -> dict:
        body: Dict[str, Any] = {}
        if experiment is not None:
            body["experiment"] = experiment
        if scenario_path is not None:
            body["scenario_path"] = scenario_path
        if seed is not None:
            body["seed"] = seed
        if session_id is not None:
            body["session_id"] = session_id
        return self._json("POST", "/sessions", body)

    def run(self, sid: str, t_ms: float,
            chunk_ms: Optional[float] = None) -> list:
        """The streamed NDJSON records (the chunks, then the summary).
        Raises ``RuntimeError`` on an in-band error record."""
        body: Dict[str, Any] = {"t_ms": t_ms}
        if chunk_ms is not None:
            body["chunk_ms"] = chunk_ms
        records = []
        with self._req("POST", f"/sessions/{sid}/run", body) as resp:
            for line in resp:               # urllib decodes the chunking
                rec = json.loads(line)
                if "error" in rec:
                    raise RuntimeError(f"server error: {rec['error']}")
                records.append(rec)
        return records

    def suspend(self, sid: str) -> dict:
        return self._json("POST", f"/sessions/{sid}/suspend")

    def resume(self, sid: str) -> dict:
        return self._json("POST", f"/sessions/{sid}/resume")

    def run_many(self, requests: Dict[str, float],
                 coalesce: bool = True) -> dict:
        return self._json("POST", "/run_many",
                          {"requests": requests, "coalesce": coalesce})

    def destroy(self, sid: str) -> dict:
        return self._json("DELETE", f"/sessions/{sid}")

    def shutdown(self) -> dict:
        return self._json("POST", "/shutdown")
