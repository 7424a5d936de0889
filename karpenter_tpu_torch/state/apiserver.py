"""The cluster's apiserver surface: typed objects over HTTP with watch
(a copy of ``karpenter_tpu/state/apiserver.py``).

Upstream karpenter is a controller against a REAL apiserver — watches,
patches, CRD persistence, admission over the network (upstream
``cmd/controller/main.go:33-71``, ``pkg/context/context.go:76-166``,
``pkg/webhooks/webhooks.go:34-63``). This module does for the
cluster side what ``cloudprovider/httpcloud.py`` did for the cloud side:
hosts the object store behind a real network boundary and serves the
controller-facing protocol:

* ``GET  /api/{kind}``               — list (returns items + resourceVersion)
* ``GET  /api/{kind}/{name}``        — get
* ``POST /api/{kind}``               — create (ADMISSION runs here: defaulting
  then validation; a rejection is an HTTP 422 carrying the reason — the
  webhook semantics of ``webhooks.go:34-63`` at the write chokepoint)
* ``PUT  /api/{kind}/{name}``        — update (admission again)
* ``DELETE /api/{kind}/{name}``
* ``POST /api/pods/{name}/bind``     — the binding subresource
* ``GET  /watch?since=V&timeout=S``  — long-poll watch: events with
  resourceVersion > V, or an empty batch after the timeout (the informer
  relist+watch shape without chunked streaming)

Injected per-request latency models a remote apiserver; the e2e lifecycle
test drives the full operator through this surface with latency on.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..api.admission import AdmissionError, admit_node_template, admit_provisioner
from ..api.codec import KIND_OF_TYPE, KINDS, to_wire
from ..utils.tracing import TRACER
from .cells import CellIndex
from .cluster import Cluster

_COLLECTIONS = {
    "pods": "pods",
    "nodes": "nodes",
    "machines": "machines",
    "provisioners": "provisioners",
    "nodetemplates": "node_templates",
    "poddisruptionbudgets": "pdbs",
}

_ADMIT = {
    "provisioners": admit_provisioner,
    "nodetemplates": admit_node_template,
}


def route_template(path: str) -> str:
    """Canonical route-template normalization for the apiserver's API
    surface: per-object paths collapse to /api/{kind}/{name}[/verb]. ONE
    definition shared by both sides of the wire — server span names here,
    client breaker/metric keys and client span names in
    ``HTTPCluster._route`` — so client and server observability always key
    the same route the same way."""
    parts = [p for p in path.split("?", 1)[0].split("/") if p]
    if len(parts) >= 2 and parts[0] == "api":
        route = f"/api/{parts[1]}"
        if len(parts) >= 3:
            route += "/{name}"
        if len(parts) >= 4:
            route += "/" + parts[3]
        return route
    return "/" + parts[0] if parts else "/"


_route_template = route_template  # local alias used by the handler below


class ClusterAPIServer:
    """Serves a backing ``Cluster`` (the authoritative store) over HTTP.

    The event log mirrors the store's watch stream with the store's own
    resource versions, so clients resume with ``since=<last seen>`` exactly
    like an informer watch bookmark."""

    def __init__(self, backing: Optional[Cluster] = None, latency_s: float = 0.0, port: int = 0):
        self.backing = backing or Cluster()
        self.latency_s = latency_s
        # event-log incarnation token: a fresh listener over the SAME backing
        # store starts a fresh log whose seqs overlap the old one's range —
        # a stale bookmark that happens to fall WITHIN the new range would
        # silently skip events (the ahead-of-log case gets "gone" below, but
        # a long-disconnected client can reconnect after the new log caught
        # up). Clients compare this token per poll and relist on change.
        import uuid as _uuid

        self.incarnation = _uuid.uuid4().hex[:12]
        # The watch log is ordered by a SERVER-assigned sequence number, not
        # the store's resource versions: the store bumps versions under its
        # lock but emits outside it, so two handler threads can deliver
        # events out of version order — a version-keyed bookmark would then
        # permanently skip the late-delivered lower version. The seq is
        # assigned under the log lock at delivery, so bookmarks never skip;
        # clients judge OBJECT staleness by resourceVersion separately.
        # (seq, version, event, kind, wire, cells, cur) — ``cells`` is the
        # tuple of cell streams the event must reach (() = every stream) and
        # ``cur`` the object's cell AFTER the event, both computed at record
        # time by the cell index so per-cell watches filter O(1); a stream
        # other than ``cur`` receives the event as an eviction (DELETED)
        self._events: List[
            Tuple[int, int, str, str, Dict, Tuple[str, ...], str]
        ] = []
        self._seq = 0
        self._log_floor = 0  # highest seq compacted away; continuity above it
        # a pre-populated backing has history the log never saw: watchers
        # starting from seq 0 must relist instead of believing they're synced
        if self.backing._version > 0:
            self._log_floor = 1
            self._seq = 1
        self._events_cv = threading.Condition()
        # Highest resource version WRITTEN per kind — served by /version so
        # clients can delta-relist: a watch-gone recovery only re-lists the
        # kinds whose version moved since the client's last relist (the
        # others provably saw no writes, so the client cache is current).
        self._kind_versions: Dict[str, int] = {}
        with self.backing._lock:
            for kind, attr in _COLLECTIONS.items():
                coll = getattr(self.backing, attr)
                if coll:
                    self._kind_versions[kind] = max(
                        o.meta.resource_version for o in coll.values()
                    )
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # cell classifier + name index behind ?cell= list/watch filtering
        # (state/cells.py): relist cost proportional to the cell, not the
        # cluster — the apiserver-side half of the sharded control plane
        self._cell_index = CellIndex(self.backing)
        self.backing.watch(self._record_event)

    # -- event log -----------------------------------------------------------
    def _record_event(self, event: str, obj) -> None:
        kind = KIND_OF_TYPE.get(type(obj))
        if kind is None:
            return
        # classified OUTSIDE the log lock (it may read the backing store):
        # the cells an event reaches are its object's current cell plus the
        # one it just left, so per-cell informer caches never go stale
        cells, cur = self._cell_index.event_cells(
            kind, obj, deleted=(event == "DELETED")
        )
        with self._events_cv:
            self._seq += 1
            version = obj.meta.resource_version
            if version > self._kind_versions.get(kind, 0):
                self._kind_versions[kind] = version
            self._events.append(
                (self._seq, version, event, kind, to_wire(obj), cells, cur)
            )
            if len(self._events) > 100_000:
                # compaction: a client whose bookmark predates the log start
                # gets a "gone" response and must relist (k8s 410 semantics)
                self._events = self._events[-50_000:]
                self._log_floor = self._events[0][0] - 1
            self._events_cv.notify_all()

    def _watch(
        self,
        since: int,
        timeout_s: float,
        cell: Optional[str] = None,
        limit: int = 0,
    ) -> Dict:
        """``limit`` caps events per response (0 = unlimited): a slow
        consumer resuming after a stall re-polls for the rest instead of
        receiving (and JSON-decoding) the entire backlog in one body — the
        server half of the client's bounded-intake backpressure."""
        deadline = time.monotonic() + timeout_s
        with self._events_cv:
            while True:
                if since < self._log_floor or since > self._seq:
                    # behind the compacted log OR AHEAD of it: a bookmark
                    # larger than every seq this server ever assigned is
                    # from a previous server incarnation (listener restart
                    # over the same backing store resets the log) — without
                    # the "gone" the client would wait forever for seqs
                    # that restart at 1 and never reach its bookmark
                    return {"gone": True}
                # seqs are dense and append-only: O(1) offset, no scan
                start = (
                    max(0, since - self._events[0][0] + 1) if self._events else 0
                )
                if start < len(self._events):
                    tail = self._events[start:]
                    if cell is not None:
                        # per-cell stream: deliver the cell's events plus
                        # every unclassified event (config kinds, daemonset
                        # pods). ``bookmark`` advances past the filtered-out
                        # tail so a quiet cell never rescans the whole log.
                        tail = [e for e in tail if not e[5] or cell in e[5]]
                        bookmark = self._events[-1][0]
                        if not tail:
                            left = deadline - time.monotonic()
                            if left <= 0:
                                return {"events": [], "bookmark": bookmark,
                                        "incarnation": self.incarnation}
                            since = bookmark
                            self._events_cv.wait(timeout=min(left, 0.5))
                            continue
                    else:
                        bookmark = tail[-1][0]
                    if limit > 0 and len(tail) > limit:
                        # truncated delivery: the bookmark must stop at the
                        # last DELIVERED event so the next poll resumes with
                        # the remainder instead of skipping it
                        tail = tail[:limit]
                        bookmark = tail[-1][0]
                    return {
                        "incarnation": self.incarnation,
                        "bookmark": bookmark,
                        "events": [
                            {
                                "seq": s,
                                "resourceVersion": v,
                                # a classified object whose CURRENT cell is
                                # elsewhere has just left this stream's
                                # cell: deliver the transition as an
                                # eviction, or this cell's informer cache
                                # holds the mover forever (its later events
                                # are tagged with the new cell only)
                                "event": (
                                    "DELETED"
                                    if cell is not None and cs
                                    and cur and cur != cell
                                    else ev
                                ),
                                "kind": k,
                                "object": w,
                            }
                            for (s, v, ev, k, w, cs, cur) in tail
                        ],
                    }
                left = deadline - time.monotonic()
                if left <= 0:
                    # the caller has seen (or filtered past) everything in
                    # the log: hand back the tail seq so a quiet per-cell
                    # stream's NEXT poll starts past it instead of
                    # re-filtering the whole shared tail every round-trip
                    return {
                        "incarnation": self.incarnation,
                        "events": [],
                        "bookmark": (
                            self._events[-1][0]
                            if self._events else self._log_floor
                        ),
                    }
                self._events_cv.wait(timeout=min(left, 0.5))

    # -- request handling ----------------------------------------------------
    def _collection(self, kind: str) -> Dict:
        return getattr(self.backing, _COLLECTIONS[kind])

    def handle(
        self, method: str, path: str, query: Dict[str, str], body: Optional[Dict]
    ) -> Tuple[int, Dict]:
        if self.latency_s:
            time.sleep(self.latency_s)
        parts = [p for p in path.split("/") if p]
        try:
            if parts == ["watch"]:
                since = int(query.get("since", "0"))
                timeout_s = min(float(query.get("timeout", "10")), 30.0)
                limit = max(0, int(query.get("limit", "0")))
                return 200, self._watch(
                    since, timeout_s, query.get("cell"), limit=limit
                )
            if parts == ["version"]:
                with self.backing._lock:
                    version = self.backing._version
                with self._events_cv:
                    seq = self._seq
                    kind_versions = dict(self._kind_versions)
                # A committed-but-unrecorded write can lag kindVersions here;
                # that is safe: its event seq exceeds the watchSeq returned in
                # the same response, so a client skipping the kind still
                # receives the write through its watch replay.
                return 200, {
                    "resourceVersion": version,
                    "watchSeq": seq,
                    "incarnation": self.incarnation,
                    "kindVersions": kind_versions,
                }
            if not parts or parts[0] != "api" or len(parts) < 2:
                return 404, {"error": f"unknown path {path}"}
            kind = parts[1]
            if kind not in _COLLECTIONS:
                return 404, {"error": f"unknown kind {kind}"}
            _, encode, decode = KINDS[kind]
            coll = self._collection(kind)
            if len(parts) == 2:
                if method == "GET":
                    cell = query.get("cell")
                    if cell is not None and kind in CellIndex.FILTERABLE:
                        # indexed per-cell list: O(cell) names from the
                        # maintained index; snapshot the matches under the
                        # lock, encode outside it (same discipline as the
                        # full list below)
                        names = sorted(self._cell_index.members(kind, cell))
                        with self.backing._lock:
                            objs = [coll[n] for n in names if n in coll]
                            version = self.backing._version
                        return 200, {
                            "items": [encode(o) for o in objs],
                            "resourceVersion": version,
                        }
                    # snapshot under the lock, ENCODE OUTSIDE it:
                    # wire-encoding a 500k-object collection holds
                    # the store lock for tens of milliseconds, stalling every
                    # write (and the watch appliers behind them) per list
                    with self.backing._lock:
                        objs = list(coll.values())
                        version = self.backing._version
                    return 200, {
                        "items": [encode(o) for o in objs],
                        "resourceVersion": version,
                    }
                if method == "POST":
                    obj = decode(body)
                    return self._write(kind, obj, create=True)
                return 405, {"error": f"{method} not allowed on collection"}
            name = parts[2]
            if len(parts) == 4 and kind == "pods" and parts[3] == "bind" and method == "POST":
                node_name = (body or {}).get("nodeName")
                if not node_name:
                    return 400, {"error": "bind body requires nodeName"}
                try:
                    self.backing.bind_pod(name, node_name)
                except KeyError:
                    return 404, {"error": f"pod {name} not found"}
                with self.backing._lock:
                    pod = self.backing.pods.get(name)
                if pod is None:
                    return 404, {"error": f"pod {name} not found"}
                return 200, to_wire(pod)
            if len(parts) != 3:
                return 404, {"error": f"unknown path {path}"}
            if method == "GET":
                with self.backing._lock:
                    obj = coll.get(name)
                if obj is None:
                    return 404, {"error": f"{kind}/{name} not found"}
                return 200, encode(obj)
            if method == "PUT":
                obj = decode(body)
                if obj.meta.name != name:
                    return 400, {"error": "name mismatch"}
                return self._write(kind, obj, create=False)
            if method == "DELETE":
                deleter = {
                    "pods": self.backing.delete_pod,
                    "nodes": self.backing.delete_node,
                    "machines": self.backing.delete_machine,
                    "provisioners": self.backing.delete_provisioner,
                }.get(kind)
                if deleter is None:
                    obj = self.backing._delete(coll, name)
                else:
                    obj = deleter(name)
                if obj is None:
                    return 404, {"error": f"{kind}/{name} not found"}
                return 200, encode(obj)
            return 405, {"error": f"{method} not allowed"}
        except AdmissionError as e:
            return 422, {
                "error": str(e),
                "admission": True,
                "kind": e.kind,
                "name": e.name,
                "fieldErrors": e.field_errors,
            }
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}

    def _write(self, kind: str, obj, create: bool) -> Tuple[int, Dict]:
        # k8s verb semantics: POST is CREATE — an existing
        # name is 409 AlreadyExists, never a silent overwrite; PUT is
        # REPLACE — a missing name is 404, so every PUT-path write records
        # MODIFIED in the watch log, never ADDED. (The check-then-write is
        # not atomic against a concurrent writer — the same discipline as
        # every other handler path over this store.)
        with self.backing._lock:
            exists = obj.meta.name in self._collection(kind)
        if create and exists:
            return 409, {
                "error": f"{kind}/{obj.meta.name} already exists",
                "reason": "AlreadyExists",
            }
        if not create and not exists:
            return 404, {"error": f"{kind}/{obj.meta.name} not found"}
        admit = _ADMIT.get(kind)
        if admit is not None:
            admit(obj)  # defaulting + validation; AdmissionError -> 422
        if kind in ("provisioners", "nodetemplates"):
            # admission already ran (over the wire); store directly so the
            # in-process chain doesn't run it twice
            self.backing._put(self._collection(kind), obj, obj.meta.name)
        else:
            adder = {
                "pods": self.backing.add_pod,
                "nodes": self.backing.add_node,
                "machines": self.backing.add_machine,
                "poddisruptionbudgets": self.backing.add_pdb,
            }[kind]
            adder(obj)
        _, encode, _ = KINDS[kind]
        with self.backing._lock:
            stored = self._collection(kind).get(obj.meta.name)
        return (201 if create else 200), encode(stored)

    # -- server lifecycle ----------------------------------------------------
    def start(self) -> "ClusterAPIServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self) -> None:
                raw_path, _, raw_q = self.path.partition("?")
                query = {}
                for pair in raw_q.split("&"):
                    if "=" in pair:
                        k, _, v = pair.partition("=")
                        query[k] = v
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw)
                    except (ValueError, UnicodeDecodeError):
                        # malformed body is a CLIENT error: answer 400 with
                        # a JSON error instead of letting the decode
                        # exception tear down the connection (a socket
                        # reset reads as a server fault and trips
                        # retry/breaker machinery for nothing)
                        payload = json.dumps(
                            {"error": "malformed JSON request body"}
                        ).encode()
                        self.send_response(400)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                        return
                # server span in the CALLER'S trace (traceparent header),
                # stamped with the originating reconcile id: one reconcile's
                # apiserver round-trips join its client span tree by trace
                # id. The watch long-poll is NOT traced (mirroring the
                # client side): a permanent background poll would churn real
                # traces out of the tracer's bounded per-trace index.
                route = _route_template(raw_path)
                if route == "/watch":
                    span_ctx = contextlib.nullcontext()
                else:
                    attrs = {}
                    reconcile_id = self.headers.get("x-karpenter-reconcile-id")
                    if reconcile_id:
                        attrs["reconcile_id"] = reconcile_id
                    span_ctx = TRACER.server_span(
                        f"apiserver.{self.command} {route}",
                        traceparent=self.headers.get("traceparent"),
                        **attrs,
                    )
                with span_ctx as span:
                    status, payload = outer.handle(
                        self.command, raw_path, query, body
                    )
                    if span is not None:
                        span.attrs["status"] = status
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = _dispatch  # noqa: N815

            def log_message(self, fmt, *args) -> None:
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # detach from the backing store: a soak restarting the listener over
        # the same backing builds a FRESH incarnation (new event log, so old
        # client bookmarks get "gone" and relist); the dead incarnation must
        # not keep accreting events
        self.backing.unwatch(self._record_event)


def main(argv=None) -> int:  # pragma: no cover - run as a subprocess by the HA tests
    """Standalone state tier: ``python -m karpenter_tpu_torch.state.apiserver``.

    The HA deployment points operator replicas at this server with
    ``--cluster-endpoint``; the store is in-process and needs no card."""
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser(prog="karpenter-tpu-state")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--latency", type=float, default=0.0,
                    help="injected per-request latency seconds (testing)")
    args = ap.parse_args(argv)
    srv = ClusterAPIServer(latency_s=args.latency, port=args.port).start()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(f"cluster api serving on {srv.endpoint}", flush=True)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
