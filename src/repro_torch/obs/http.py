"""Embedded HTTP admin plane: ``/metrics``, ``/healthz``, ``/stats``,
``/trace/<request_id>`` — the port's copy of ``repro.obs.http``.  The
port's pool master, scheduler and serving engine register here.

A stdlib-only (``http.server``) scrape endpoint the pool opts into via
``PoolConfig(obs_http_port=...)`` or ``REPRO_OBS_HTTP_PORT`` (port 0 =
ephemeral, the chosen port is on ``server.port``).  Components don't
serve HTTP themselves — they register a named *snapshot source*
(:func:`register_source`, any zero-arg callable returning a
``repro_torch.stats`` snapshot) and optionally a *trace resolver*
(:func:`register_trace_resolver`, mapping a request-id/trace-id string
to a :class:`repro_torch.obs.Timeline`).  The handler merges whatever is
registered at scrape time:

- ``GET /metrics`` — Prometheus text exposition
  (:func:`repro_torch.obs.export.to_prometheus` of the merged snapshot, real
  cumulative histograms, per-worker health gauges);
- ``GET /healthz`` — liveness JSON: ``ok`` (every source answered),
  source names, ``pool_workers_live`` and per-worker health when a pool
  is registered (503 when a source failed);
- ``GET /stats`` — the merged snapshot as JSON, same content the
  ``--stats-every`` console line prints (and what
  ``python -m repro_torch.obs.top`` polls);
- ``GET /trace/<rid>`` — one request's merged span timeline as
  canonical span JSON, or Chrome ``trace_event`` JSON with
  ``?format=chrome`` (open in about://tracing / Perfetto).

Sources/resolvers registration is process-global and independent of the
server lifecycle, so components register unconditionally (harmless when
no server ever starts) and a server started later sees them all.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from ..stats import merge_snapshots
from .export import to_chrome_trace, to_json, to_prometheus

__all__ = [
    "ObsHttpServer",
    "merged_snapshot",
    "register_source",
    "register_trace_resolver",
    "server",
    "start_server",
    "stop_server",
    "unregister_source",
    "unregister_trace_resolver",
]

_lock = threading.Lock()
_sources: Dict[str, Callable[[], Dict]] = {}
_resolvers: List[Callable[[str], Optional[object]]] = []
_server: Optional["ObsHttpServer"] = None


def register_source(name: str, snapshot_fn: Callable[[], Dict]) -> str:
    """Register a named snapshot callable; returns the (deduplicated)
    name actually used — a second ``"pool"`` becomes ``"pool#2"`` so
    two masters in one process both stay scrapeable."""
    with _lock:
        use = name
        n = 1
        while use in _sources:
            n += 1
            use = f"{name}#{n}"
        _sources[use] = snapshot_fn
    return use


def unregister_source(name: str) -> None:
    with _lock:
        _sources.pop(name, None)


def register_trace_resolver(fn: Callable[[str], Optional[object]]) -> None:
    """Register a callable mapping a request-id/trace-id string to a
    Timeline (or None when it doesn't know the id)."""
    with _lock:
        if fn not in _resolvers:
            _resolvers.append(fn)


def unregister_trace_resolver(fn: Callable[[str], Optional[object]]) -> None:
    with _lock:
        if fn in _resolvers:
            _resolvers.remove(fn)


def merged_snapshot() -> Dict[str, object]:
    """Every registered source's snapshot, merged (errors recorded as
    ``obs_source_errors`` instead of failing the scrape)."""
    with _lock:
        sources = list(_sources.items())
    snaps = []
    errors = 0
    for _, fn in sources:
        try:
            snaps.append(fn())
        except Exception:
            errors += 1
    merged = merge_snapshots(*snaps) if snaps else {}
    if errors:
        merged["obs_source_errors"] = errors
    return merged


def _resolve_trace(key: str):
    with _lock:
        resolvers = list(_resolvers)
    for fn in resolvers:
        try:
            timeline = fn(key)
        except Exception:
            continue
        if timeline is not None:
            return timeline
    # fall back to the process tracer: the key may be a raw trace id
    from .trace import tracer

    timeline = tracer().timeline(key)
    return timeline if timeline.spans else None


def _healthz() -> Dict[str, object]:
    with _lock:
        sources = list(_sources.items())
    doc: Dict[str, object] = {"ok": True, "sources": []}
    for name, fn in sources:
        try:
            snap = fn()
        except Exception as e:
            doc["ok"] = False
            doc.setdefault("errors", {})[name] = f"{type(e).__name__}: {e}"
            continue
        doc["sources"].append(name)
        live = snap.get("pool_workers_live")
        if live is not None:
            doc["pool_workers_live"] = live
        health = snap.get("pool_worker_health_by_wid")
        if isinstance(health, dict):
            doc["pool_worker_health"] = {
                k: round(float(v), 4) for k, v in health.items()
            }
    return doc


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def log_message(self, *args) -> None:  # silence per-request stderr
        pass

    def _respond(self, code: int, body: str, content_type: str) -> None:
        payload = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        try:
            url = urlparse(self.path)
            path = url.path.rstrip("/") or "/"
            if path == "/metrics":
                self._respond(
                    200, to_prometheus(merged_snapshot()),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/healthz":
                doc = _healthz()
                self._respond(
                    200 if doc["ok"] else 503,
                    json.dumps(doc, sort_keys=True) + "\n",
                    "application/json",
                )
            elif path == "/stats":
                self._respond(
                    200,
                    json.dumps(
                        merged_snapshot(), sort_keys=True, default=str
                    ) + "\n",
                    "application/json",
                )
            elif path.startswith("/trace/"):
                key = path[len("/trace/"):]
                timeline = _resolve_trace(key)
                if timeline is None:
                    self._respond(
                        404, f"no timeline for {key!r}\n", "text/plain"
                    )
                    return
                fmt = parse_qs(url.query).get("format", ["json"])[0]
                if fmt == "chrome":
                    self._respond(
                        200, to_chrome_trace(timeline, indent=1),
                        "application/json",
                    )
                else:
                    self._respond(
                        200, to_json(timeline, indent=1), "application/json"
                    )
            else:
                self._respond(
                    404,
                    "repro obs endpoints: /metrics /healthz /stats "
                    "/trace/<request_id>\n",
                    "text/plain",
                )
        except BrokenPipeError:  # scraper went away mid-write
            pass
        except Exception as e:  # never kill the serving thread
            try:
                self._respond(
                    500, f"{type(e).__name__}: {e}\n", "text/plain"
                )
            except OSError:
                pass


class ObsHttpServer:
    """The admin server: ``ThreadingHTTPServer`` on a daemon thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


def start_server(port: Optional[int] = None) -> ObsHttpServer:
    """Start (or return the already-running) process-wide admin server.

    ``port=None`` reads ``REPRO_OBS_HTTP_PORT`` (via ``repro_torch.settings``);
    0 binds an ephemeral port.  One server per process: a second caller
    gets the existing instance regardless of the port it asked for.
    """
    global _server
    with _lock:
        if _server is not None:
            return _server
    if port is None:
        from .. import settings

        port = settings.get_int("obs_http_port")
        if port is None:
            port = 0
    srv = ObsHttpServer(port=int(port))
    with _lock:
        if _server is None:
            _server = srv
            return srv
    srv.stop()  # lost the race; serve from the winner
    return _server


def stop_server() -> None:
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()


def server() -> Optional[ObsHttpServer]:
    with _lock:
        return _server
