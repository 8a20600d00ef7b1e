"""Per-node operations HTTP server: /metrics, /healthz, /logspec,
/version, /debug/pprof, /debug/traces, /debug/slo, /debug/tsdb.

Reference parity: ``core/operations/system.go`` — one HTTP endpoint per
node serving prometheus metrics, component health checks (fabric-lib-go
healthz pattern: named checkers, 503 + failing list on any failure),
dynamic log-spec GET/PUT, and version info — plus the pprof surface the
reference gates behind ``General.Profile.Enabled``
(``orderer/common/server/main.go:312-317``): ``/debug/pprof/profile``
samples the process under cProfile for N seconds and returns the top
cumulative entries, ``/debug/pprof/threads`` dumps every thread's stack
(goroutine-dump analogue).

``/debug/traces`` serves the tracer's completed-trace ring buffer as
JSON (last N traces, per-span timings) — the span side of the
observability surface (see :mod:`bdls_tpu_torch.utils.tracing`). The server
also binds its metrics provider to the tracer so span-duration
histograms render on ``/metrics``, and serves the live SLO verdict over
the same two surfaces at ``/debug/slo`` (:mod:`bdls_tpu_torch.utils.slo`).

The port's copy of ``bdls_tpu/utils/operations.py``, with every route;
``/version`` reports the port's own ``bdls_tpu_torch.__version__``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from bdls_tpu_torch import __version__
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.flog import GLOBAL as LOGS
from bdls_tpu_torch.utils.metrics import MetricsProvider


class OperationsSystem:
    def __init__(
        self,
        metrics: Optional[MetricsProvider] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        version: str = __version__,
        profile_enabled: bool = True,
        tracer: Optional[tracing.Tracer] = None,
        process: str = "",
        tsdb=None,
    ):
        self.metrics = metrics or MetricsProvider()
        self.tracer = tracer or tracing.GLOBAL
        # optional bdls_tpu_torch.obs.tsdb.TimeSeriesDB served at
        # /debug/tsdb
        self.tsdb = tsdb
        # self-reported process identity for the fleet collector
        # (the reference's bdls_tpu.obs) — the label a scrape falls back
        # to when the operator didn't name the endpoint
        self.process = process
        self.tracer.bind_metrics(self.metrics)
        self.version = version
        self.profile_enabled = profile_enabled
        self._checkers: dict[str, Callable[[], Optional[str]]] = {}
        self._lock = threading.Lock()
        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._reply(
                        200,
                        ops.metrics.render_prometheus().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif self.path == "/healthz":
                    status, failed = ops.health_status()
                    body = json.dumps(
                        {
                            "status": "OK" if status else "Service Unavailable",
                            "failed_checks": failed,
                        }
                    ).encode()
                    self._reply(200 if status else 503, body)
                elif self.path == "/logspec":
                    self._reply(200, json.dumps({"spec": LOGS.spec()}).encode())
                elif self.path == "/version":
                    self._reply(200, json.dumps({"version": ops.version}).encode())
                elif self.path.startswith("/debug/pprof/profile"):
                    if not ops.profile_enabled:
                        self._reply(403, b'{"error":"profiling disabled"}')
                        return
                    query = parse_qs(urlparse(self.path).query)
                    try:
                        seconds = float(query.get("seconds", ["2"])[0])
                    except ValueError:
                        self._reply(400, b'{"error":"bad seconds"}')
                        return
                    seconds = max(0.0, min(seconds, 30.0))
                    self._reply(200, ops.cpu_profile(seconds).encode(),
                                "text/plain")
                elif self.path.startswith("/debug/traces"):
                    query = parse_qs(urlparse(self.path).query)
                    try:
                        limit = int(query.get("limit", ["16"])[0])
                    except ValueError:
                        self._reply(400, b'{"error":"bad limit"}')
                        return
                    limit = max(1, min(limit, ops.tracer.max_traces))
                    body = json.dumps(
                        {
                            "traces": ops.tracer.completed(limit),
                            # process + anchor metadata for cross-process
                            # stitching (the reference's obs.collector)
                            "process": ops.process,
                            "anchor_unix_ns": ops.tracer.anchor_unix_ns,
                            "anchor_mono_ns": ops.tracer.anchor_mono_ns,
                        }
                    ).encode()
                    self._reply(200, body)
                elif self.path.startswith("/debug/slo"):
                    # live SLO verdict over this node's tracer + metrics
                    # (same substrate /debug/traces and /metrics serve)
                    from bdls_tpu_torch.utils import slo

                    try:
                        verdict = slo.evaluate(
                            tracer=ops.tracer, metrics=ops.metrics)
                        self._reply(200, json.dumps(verdict).encode())
                    except Exception as exc:  # noqa: BLE001 - debug surface
                        self._reply(500, json.dumps(
                            {"error": repr(exc)[:300]}).encode())
                elif self.path.startswith("/debug/tsdb"):
                    if ops.tsdb is None:
                        self._reply(404, b'{"error":"no tsdb attached"}')
                        return
                    query = parse_qs(urlparse(self.path).query)
                    try:
                        limit = query.get("limit")
                        limit = int(limit[0]) if limit else None
                    except ValueError:
                        self._reply(400, b'{"error":"bad limit"}')
                        return
                    try:
                        body = json.dumps(ops.tsdb.snapshot(limit=limit))
                        self._reply(200, body.encode())
                    except Exception as exc:  # noqa: BLE001 - debug surface
                        self._reply(500, json.dumps(
                            {"error": repr(exc)[:300]}).encode())
                elif self.path == "/debug/pprof/threads":
                    if not ops.profile_enabled:
                        self._reply(403, b'{"error":"profiling disabled"}')
                        return
                    self._reply(200, ops.thread_dump().encode(), "text/plain")
                else:
                    self._reply(404, b'{"error":"not found"}')

            def do_PUT(self):
                if self.path != "/logspec":
                    self._reply(404, b'{"error":"not found"}')
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    LOGS.set_spec(payload["spec"])
                    self._reply(204, b"")
                except (KeyError, ValueError) as exc:
                    self._reply(400, json.dumps({"error": str(exc)}).encode())

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    # ---- profiling surface (pprof analogue) ------------------------------
    def cpu_profile(self, seconds: float, hz: float = 100.0) -> str:
        """Statistical profile of ALL threads: sample every thread's
        stack via ``sys._current_frames()`` at ``hz`` for ``seconds`` and
        render frames by inclusive sample count (a cProfile.enable() here
        would instrument only this handler thread, which just sleeps)."""
        interval = 1.0 / hz
        deadline = time.monotonic() + seconds
        own = threading.get_ident()
        counts: dict[str, int] = {}
        samples = 0
        while time.monotonic() < deadline:
            for ident, frame in sys._current_frames().items():
                if ident == own:
                    continue
                f = frame
                while f is not None:
                    code = f.f_code
                    key = f"{code.co_filename}:{f.f_lineno} {code.co_name}"
                    counts[key] = counts.get(key, 0) + 1
                    f = f.f_back
            samples += 1
            time.sleep(interval)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:60]
        lines = [f"samples: {samples} over {seconds:.1f}s at {hz:.0f}Hz",
                 "inclusive  frame"]
        lines += [f"{n:9d}  {key}" for key, n in top]
        return "\n".join(lines) + "\n"

    def thread_dump(self) -> str:
        """Every thread's current stack (the goroutine-dump analogue)."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        parts = []
        for ident, frame in frames.items():
            parts.append(f"--- thread {names.get(ident, ident)} ({ident})\n"
                         + "".join(traceback.format_stack(frame)))
        return "\n".join(parts)

    def register_checker(
        self, name: str, check: Callable[[], Optional[str]]
    ) -> None:
        """check() returns None when healthy, else a failure message
        (e.g. the TPU provider's device probe)."""
        with self._lock:
            self._checkers[name] = check

    def health_status(self) -> tuple[bool, list[dict]]:
        failed = []
        with self._lock:
            checkers = dict(self._checkers)
        for name, check in checkers.items():
            try:
                msg = check()
            except Exception as exc:
                msg = str(exc)
            if msg is not None:
                failed.append({"component": name, "reason": msg})
        return not failed, failed

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        # shutdown() waits for serve_forever to return: called on a
        # server never started it would wait forever
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=2.0)
            self._thread = None
        self._server.server_close()
