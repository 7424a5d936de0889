"""Operator HTTP surface: /metrics, /healthz, /readyz, /debug/*.

Rebuild of the reference's manager endpoints
(upstream ``cmd/controller/main.go:33-71`` wires the metrics server on
:8080 and health probes on :8081 through controller-runtime): a small stdlib
HTTP server exposing the Prometheus exposition of ``utils.metrics.REGISTRY``
plus liveness/readiness probes backed by operator-supplied callables.

Debug surface (the pprof-flag analogue, always on and cheap):

* ``/debug/traces`` — JSON dump of the tracer's retained root span trees
  (most recent first), e.g. the full encode -> solve -> decode -> validate
  breakdown the solver records, with the controller kit's ``reconcile_id``
  correlation attrs so a trace joins to its log lines; ``?trace_id=`` narrows
  to one distributed trace (client + apiserver + cloud roots sharing the
  propagated W3C trace id);
* ``/debug/events`` — the Recorder's recent-events ring (newest first,
  ``?limit=N`` caps the window, default 256);
* ``/debug/decisions`` — the scheduling-decision audit log
  (utils/decisions.py): placement / nomination / consolidation verdicts,
  newest first, filterable by ``?pod=``, ``?node=``, ``?reconcile_id=``,
  ``?trace_id=``, ``?kind=`` and capped by ``?limit=``.
* ``/debug/flightrecorder`` — the reconcile flight recorder
  (utils/flightrecorder.py): newest-first capsule summaries;
  ``/debug/flightrecorder/<id>`` fetches one complete capsule as gzip'd
  JSON (``Content-Encoding: gzip``) for offline replay via
  ``python -m karpenter_tpu_torch.replay``; ``?dump=1`` additionally writes it
  to the configured ``flight_recorder_dump_dir`` and returns the path.
* ``/debug/cells`` — the sharded control plane's partition view
  (state/cells.py): current cells with pending-pod counts, the last sharded
  round's per-cell summaries (digest, cost, encode mode, marginal price),
  and — with ``?pod=<name>`` — which cell owns a pod and why (feasible
  provisioners, zone pin, gang, residue reason). ``{"enabled": false}``
  while ``cell_sharding_enabled`` is off.
* ``/debug/lifecycle`` — the pod-lifecycle attribution tracker
  (utils/lifecycle.py): recent completed waterfalls plus aggregate stage
  totals and the dominant stage; ``?pod=<name>`` renders ONE pod's stage
  waterfall (intake -> batch -> solve -> validate -> launch -> bind, wait
  vs in-stage decomposition) cross-linked to its trace_id, reconcile_id
  and DecisionRecords.
* ``/debug/federation`` — the federation client's view of the global arbiter
  (federation/client.py): mode (federated vs degraded), per-route breaker
  states, last error, summary seq and the degraded-lease backlog size.
  ``{"enabled": false}`` while ``federation_enabled`` is off.
* ``/debug/slo`` — the SLO burn-rate engine (utils/slo.py): per objective,
  the configured threshold/target, per-window (fast/slow) good/bad traffic
  and burn rate, and error budget remaining.
* ``/debug/costs`` — the cost ledger (utils/costledger.py): settled spend
  totals, on-demand counterfactual, spot/consolidation savings and
  interruption-loss streams, windowed burn rate, per-consumer rollups
  (``?provisioner=``, ``?cell=``, ``?gang=``, ``?window=``) cross-linked to
  DecisionRecords, and the conservation verdict (attributed == metered).
  ``{"enabled": false}`` while ``cost_ledger_enabled`` is off.
* ``/debug/profile`` — the sampling CPU profiler (utils/profiling.py):
  collapsed-stack text by default (heaviest first, per-thread-role tagged),
  ``?format=speedscope`` for a speedscope JSON document, ``?seconds=N``
  blocks while an on-demand sampling window runs (works even when
  ``profiling_enabled`` is off — the thread exists only for the window),
  ``?start=1`` / ``?stop=1`` toggle continuous sampling, ``?reset=1``
  clears the table first, ``?status=1`` returns the profiler state.
* ``/debug/perf`` — the perf-regression sentinel (utils/profiling.py):
  per-(phase, mode) and per-bucket baselines (p50/p99/MAD), live EWMAs,
  band positions and streaks, plus the trip-history ring — the first stop
  after ``karpenter_tpu_perf_regression_total`` fires.

``GET /debug`` is the index: a JSON route list with one-line descriptions,
served from the ``DEBUG_ROUTES`` table — one source of truth, no drift.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs

from .decisions import DECISIONS, DecisionLog
from .flightrecorder import FLIGHT, FlightRecorder
from .lifecycle import LIFECYCLE
from .metrics import REGISTRY, Registry
from .slo import SLO
from .tracing import TRACER, Tracer

#: The one-source-of-truth debug route table: path -> one-line description.
#: ``GET /debug`` serves it verbatim.
DEBUG_ROUTES = {
    "/debug/traces": (
        "retained root span trees, newest first (?trace_id= narrows to one "
        "distributed trace)"
    ),
    "/debug/events": "recent recorder events, newest first (?limit=)",
    "/debug/decisions": (
        "scheduling-decision audit log (?pod=, ?node=, ?reconcile_id=, "
        "?trace_id=, ?kind=, ?limit=)"
    ),
    "/debug/flightrecorder": (
        "reconcile capsule ring; /debug/flightrecorder/<id> fetches one "
        "capsule as gzip'd JSON for offline replay (?dump=1 writes it)"
    ),
    "/debug/cells": (
        "sharded control plane partition view (?pod= explains one pod's "
        "cell assignment)"
    ),
    "/debug/lifecycle": (
        "pod-lifecycle stage attribution (?pod= renders one waterfall, "
        "?limit=)"
    ),
    "/debug/federation": "federation client's view of the global arbiter",
    "/debug/slo": "SLO burn rates and error budget remaining per objective",
    "/debug/costs": (
        "cost-ledger rollups: spend, savings/loss streams, burn rate and "
        "conservation verdict (?provisioner=, ?cell=, ?gang=, ?window=)"
    ),
    "/debug/profile": (
        "sampling CPU profiler: collapsed stacks (?format=speedscope, "
        "?seconds= runs an on-demand window, ?start=1/?stop=1 toggle "
        "continuous mode, ?reset=1, ?status=1)"
    ),
    "/debug/perf": (
        "perf-regression sentinel: per-phase/bucket baselines, live EWMA "
        "vs MAD band, streaks and trip history"
    ),
}


class OperatorHTTPServer:
    def __init__(
        self,
        port: int = 0,
        registry: Optional[Registry] = None,
        ready_check: Optional[Callable[[], bool]] = None,
        healthy_check: Optional[Callable[[], bool]] = None,
        leader_check: Optional[Callable[[], bool]] = None,
        tracer: Optional[Tracer] = None,
        recorder: Optional[object] = None,
        decisions: Optional[DecisionLog] = None,
        flightrecorder: Optional[FlightRecorder] = None,
        cells: Optional[Callable[[Optional[str]], dict]] = None,
        federation: Optional[Callable[[], dict]] = None,
        costs: Optional[Callable[..., dict]] = None,
        host: str = "127.0.0.1",
    ):
        self.registry = registry or REGISTRY
        self.ready_check = ready_check or (lambda: True)
        self.healthy_check = healthy_check or (lambda: True)
        # /leaderz is leadership observability, DISTINCT from readiness: a
        # standby replica is Ready (it can serve probes and take over) but
        # not leader — gating /readyz on leadership would wedge a
        # two-replica Deployment's rolling update at 1/2 Ready forever
        self.leader_check = leader_check or (lambda: True)
        self.tracer = tracer or TRACER
        # the events Recorder; the operator assigns this when it adopts a
        # server started before it existed (the entrypoint boots the HTTP
        # surface before leader election) — the handler reads it per request
        self.recorder = recorder
        self.decisions = decisions or DECISIONS
        self.flightrecorder = flightrecorder or FLIGHT
        # the sharded control plane's partition view: a callable (pod name or
        # None) -> payload; like the recorder, the operator late-binds this
        # when it adopts a server started before the controllers existed
        self.cells = cells
        # federation client status: a zero-arg callable -> payload, late-bound
        # by the operator when settings.federation_enabled (same adoption
        # pattern as `cells`)
        self.federation = federation
        # cost-ledger rollups: the ledger's debug_payload (kwargs:
        # provisioner/cell/gang/window), late-bound by the operator when
        # settings.cost_ledger_enabled (same adoption pattern as `cells`)
        self.costs = costs
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    body = outer.registry.exposition().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                elif path == "/healthz":
                    ok = outer.healthy_check()
                    body = (b"ok" if ok else b"unhealthy") + b"\n"
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "text/plain")
                elif path == "/readyz":
                    ok = outer.ready_check()
                    body = (b"ok" if ok else b"not ready") + b"\n"
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "text/plain")
                elif path == "/leaderz":
                    ok = outer.leader_check()
                    body = (b"leader" if ok else b"standby") + b"\n"
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "text/plain")
                elif path == "/debug/traces":
                    q = parse_qs(query)
                    trace_id = q.get("trace_id", [None])[0]
                    body = json.dumps(
                        {"traces": outer.tracer.export(trace_id=trace_id)},
                        default=str,
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/decisions":
                    q = parse_qs(query)

                    def arg(name):
                        return q.get(name, [None])[0]

                    try:
                        limit = max(0, int(arg("limit") or 256))
                    except ValueError:
                        limit = 256
                    records = outer.decisions.query(
                        pod=arg("pod"), node=arg("node"),
                        reconcile_id=arg("reconcile_id"),
                        trace_id=arg("trace_id"), kind=arg("kind"),
                        limit=limit,
                    )
                    body = json.dumps(
                        {"decisions": [r.to_dict() for r in records]},
                        default=str,
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/flightrecorder":
                    body = json.dumps(
                        {"capsules": outer.flightrecorder.list()}, default=str
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path.startswith("/debug/flightrecorder/"):
                    capsule_id = path[len("/debug/flightrecorder/"):]
                    q = parse_qs(query)
                    if q.get("dump", ["0"])[0] in ("1", "true"):
                        try:
                            dumped = outer.flightrecorder.dump(capsule_id)
                        except OSError as e:
                            body = json.dumps({"error": str(e)}).encode()
                            self.send_response(400)
                            self.send_header("Content-Type", "application/json")
                        else:
                            if dumped is None:
                                body = b'{"error": "unknown capsule"}\n'
                                self.send_response(404)
                            else:
                                body = json.dumps({"path": dumped}).encode()
                                self.send_response(200)
                            self.send_header("Content-Type", "application/json")
                    else:
                        payload = outer.flightrecorder.get_gzip(capsule_id)
                        if payload is None:
                            body = b'{"error": "unknown capsule"}\n'
                            self.send_response(404)
                            self.send_header("Content-Type", "application/json")
                        else:
                            body = payload
                            self.send_response(200)
                            self.send_header("Content-Type", "application/json")
                            self.send_header("Content-Encoding", "gzip")
                elif path == "/debug/cells":
                    q = parse_qs(query)
                    fn = outer.cells
                    payload = (
                        fn(q.get("pod", [None])[0])
                        if fn is not None
                        else {"enabled": False, "cells": []}
                    )
                    body = json.dumps(payload, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/lifecycle":
                    q = parse_qs(query)
                    pod = q.get("pod", [None])[0]
                    if pod:
                        waterfall = LIFECYCLE.waterfall(pod)
                        if waterfall is None:
                            body = json.dumps(
                                {"error": f"no lifecycle timeline for pod {pod!r}"}
                            ).encode()
                            self.send_response(404)
                        else:
                            # cross-link: the pod's audit-log verdicts join
                            # the waterfall to WHY it landed where it did
                            waterfall["decisions"] = [
                                r.to_dict()
                                for r in outer.decisions.query(pod=pod, limit=32)
                            ]
                            body = json.dumps(waterfall, default=str).encode()
                            self.send_response(200)
                    else:
                        try:
                            limit = max(0, int(q.get("limit", ["64"])[0]))
                        except ValueError:
                            limit = 64
                        body = json.dumps(
                            LIFECYCLE.snapshot(limit=limit), default=str
                        ).encode()
                        self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/federation":
                    fn = outer.federation
                    payload = fn() if fn is not None else {"enabled": False}
                    body = json.dumps(payload, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/slo":
                    body = json.dumps(SLO.snapshot(), default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/costs":
                    q = parse_qs(query)

                    def carg(name):
                        return q.get(name, [None])[0]

                    fn = outer.costs
                    if fn is None:
                        payload = {"enabled": False}
                    else:
                        try:
                            window = float(carg("window") or 0) or None
                        except ValueError:
                            window = None
                        payload = fn(
                            provisioner=carg("provisioner"), cell=carg("cell"),
                            gang=carg("gang"), window=window,
                        )
                    body = json.dumps(payload, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/profile":
                    from . import profiling

                    q = parse_qs(query)

                    def parg(name):
                        return q.get(name, [None])[0]

                    profiler = profiling.PROFILER
                    if parg("reset") in ("1", "true"):
                        profiler.reset()
                    if parg("start") in ("1", "true"):
                        profiler.start()
                        body = json.dumps(profiler.snapshot()).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                    elif parg("stop") in ("1", "true"):
                        profiler.stop()
                        body = json.dumps(profiler.snapshot()).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                    elif parg("status") in ("1", "true"):
                        body = json.dumps(profiler.snapshot()).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                    else:
                        try:
                            seconds = float(parg("seconds") or 0)
                        except ValueError:
                            seconds = 0.0
                        if seconds > 0:
                            # blocking on-demand window (capped): sample,
                            # wait it out on THIS handler thread (the server
                            # is threading), then export what it caught
                            import time as _time

                            seconds = min(seconds, 60.0)
                            profiler.start_window(seconds)
                            deadline = _time.monotonic() + seconds + 0.25
                            while profiler.running and _time.monotonic() < deadline:
                                _time.sleep(0.02)
                        if parg("format") == "speedscope":
                            body = json.dumps(profiler.speedscope()).encode()
                            self.send_response(200)
                            self.send_header("Content-Type", "application/json")
                        else:
                            body = (profiler.collapsed() + "\n").encode()
                            self.send_response(200)
                            self.send_header("Content-Type", "text/plain")
                elif path == "/debug/perf":
                    from . import profiling

                    body = json.dumps(
                        profiling.SENTINEL.snapshot(), default=str
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path in ("/debug", "/debug/"):
                    # the index: the DEBUG_ROUTES table verbatim — the same
                    # table the endpoint drift gate validates
                    body = json.dumps({
                        "routes": [
                            {"path": p, "description": d}
                            for p, d in DEBUG_ROUTES.items()
                        ],
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/events":
                    try:
                        limit = max(0, int(parse_qs(query).get("limit", ["256"])[0]))
                    except ValueError:
                        limit = 256
                    recorder = outer.recorder
                    events = recorder.recent(limit) if recorder is not None else []
                    body = json.dumps(
                        {"events": [e.to_dict() for e in events]}, default=str
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:  # quiet by default
                pass

        # Default loopback for tests; the operator entrypoint passes 0.0.0.0 so
        # kubelet probes (pod IP) and Prometheus scrapes reach the pod.
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "OperatorHTTPServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
