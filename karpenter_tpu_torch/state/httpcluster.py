"""HTTPCluster: the controllers' cluster client over the apiserver wire
(a copy of ``karpenter_tpu/state/httpcluster.py``).

Upstream controllers read through controller-runtime's CACHED client
(informers list+watch the apiserver; reads hit the local cache, writes go to
the server — upstream ``pkg/context/context.go:76-166`` builds exactly
that stack). ``HTTPCluster`` is the same shape against
``state/apiserver.py``:

* it IS a ``Cluster`` (subclass) — every query controllers use
  (``pending_pods``, ``existing_capacity``, ``pdbs_for_pod``...) reads the
  local informer cache with zero wire traffic;
* every WRITE (add/update/delete/bind) goes over HTTP first — the server
  runs admission at that boundary and its rejection surfaces here as
  ``AdmissionError`` (the webhook deny path) — then applies to the local
  cache immediately (read-your-writes, like an optimistic informer update);
* a watch loop long-polls ``/watch`` and applies remote events idempotently
  by resource version, firing the same watch callbacks controllers register
  against an in-process ``Cluster`` (the informer event handlers). A "gone"
  response triggers a full relist, k8s-style.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from typing import Deque, Dict, Optional

from ..api.admission import AdmissionError
from ..api.codec import KINDS, kind_of, to_wire
from ..api.objects import (
    Machine,
    Node,
    NodeTemplate,
    Pod,
    PodDisruptionBudget,
    Provisioner,
)
from ..utils import metrics, tracing
from .cells import CellIndex
from ..utils.logging import context_fields, get_logger, kv
from ..utils.resilience import (
    BreakerSet,
    CircuitOpenError,
    RetryPolicy,
    resilient_call,
)
from .cluster import Cluster

_COLLECTION_ATTR = {
    "pods": "pods",
    "nodes": "nodes",
    "machines": "machines",
    "provisioners": "provisioners",
    "nodetemplates": "node_templates",
    "poddisruptionbudgets": "pdbs",
}

#: intake-queue marker: the applier must run a full relist at this point in
#: the stream (watch-gone recovery, or a shed). Relists run ONLY on the
#: applier thread so a relist can never interleave with event application —
#: a stale queued MODIFIED applied after the relist's cache replace would
#: resurrect a deleted object.
_RELIST = object()

#: backpressure tuning: internal constants by design — the one exposed
#: setting is the capacity bound (settings.watch_queue_capacity)
_WIDEN_HIGH_FRAC = 0.5   # drained batch above this fraction of capacity = lag
_WIDEN_AFTER = 3         # consecutive lagged drains before widening engages
_WIDEN_WINDOW_S = 0.2    # widened accumulate window before a coalesced apply


class HTTPCluster(Cluster):
    def __init__(
        self,
        endpoint: str,
        timeout_s: float = 10.0,
        watch: bool = True,
        retry_policy: Optional[RetryPolicy] = None,
        breakers: Optional[BreakerSet] = None,
        cell: Optional[str] = None,
        queue_capacity: int = 8192,
    ):
        super().__init__()
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s
        # per-cell scope (sharded control plane, state/cells.py): when set,
        # lists of the partitionable kinds hit the server's indexed
        # ``?cell=`` endpoint and the watch long-poll subscribes to that
        # cell's stream — relist and event cost become O(cell), not
        # O(cluster). Config kinds (provisioners, nodetemplates, PDBs) and
        # daemonset pods are delivered to every cell.
        self.cell = cell
        # shared resilience layer (utils/resilience.py): every apiserver call
        # retries transient failures with jittered backoff under a
        # per-endpoint breaker; the watch thread reuses the same policy's
        # backoff schedule for reconnects (see _watch_loop)
        self.retry_policy = retry_policy or RetryPolicy()
        self.breakers = breakers or BreakerSet("apiserver")
        self._transport = self._http_transport  # swappable (ScriptedTransport)
        self._log = get_logger("httpcluster")
        self._bookmark = 0  # server watch seq consumed so far
        # (kind, name) -> deferred events: the watch echo for a self-initiated
        # write can land BEFORE the write path's own cache apply (the
        # long-poll is already parked server-side). Applying it would
        # pop/replace the caller's instance under it, but DROPPING it would
        # also drop a concurrent third-party write to the same object — so
        # events arriving during the in-flight window are deferred and
        # replayed when the write completes (per-object version guard makes
        # the replay idempotent).
        self._inflight: Dict[tuple, list] = {}
        # per-kind server version at the LAST relist: a recovery relist skips
        # kinds whose server-side version hasn't moved since (no writes ->
        # the local cache plus applied watch events is provably current)
        self._kind_seen: Dict[str, int] = {}
        # server event-log incarnation adopted at relist: a restarted
        # listener's fresh log can catch up PAST a stale bookmark, which
        # the seq-range "gone" check alone cannot detect — a changed token
        # on any poll forces the relist instead of silently skipping the
        # new log's earlier events
        self._server_incarnation: Optional[str] = None
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._apply_thread: Optional[threading.Thread] = None
        # -- bounded watch-event intake (backpressure) ----------------------
        # The watch thread FETCHES (network) and the applier thread APPLIES
        # (cache + controller callbacks), decoupled by a bounded queue so an
        # event storm against a busy consumer degrades deterministically
        # instead of growing memory without bound: under sustained lag the
        # applier widens its batch window and coalesces to the newest event
        # per object; an overflowing queue is shed wholesale and the cache
        # rebuilt by relist (O(cluster) time, O(1) extra memory). Both
        # surface as karpenter_tpu_backpressure_events_total{action}.
        self.queue_capacity = max(int(queue_capacity), 1)
        self._intake: Deque[object] = deque()
        self._intake_cv = threading.Condition()
        self._relist_gen = 0     # bumped by the applier after each relist
        self._lag_streak = 0     # consecutive lagged drains (applier-only)
        self._widened = False
        self._quiesced = 0       # reconcile-round holds (see quiesce())
        self._applying = False   # applier mid-batch (quiesce waits it out)
        self.relist()
        if watch:
            self._apply_thread = threading.Thread(
                target=self._apply_loop, daemon=True
            )
            self._apply_thread.start()
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True
            )
            self._watch_thread.start()

    # -- wire ----------------------------------------------------------------
    def _http_transport(self, method: str, path: str, body: Optional[Dict]) -> Dict:
        """One wire attempt; raw urllib errors propagate for classification."""
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            f"{self.endpoint}{path}", data=data, method=method
        )
        if data is not None:
            req.add_header("Content-Type", "application/json")
        # trace propagation (W3C traceparent): the server opens a span in the
        # SAME trace, so one reconcile's client, apiserver and cloud spans
        # join on /debug/traces. The reconcile correlation id rides along so
        # server-side spans carry the originating reconcile.
        traceparent = tracing.current_traceparent()
        if traceparent:
            req.add_header("traceparent", traceparent)
        reconcile_id = context_fields().get("reconcile_id")
        if reconcile_id:
            req.add_header("x-karpenter-reconcile-id", str(reconcile_id))
        timeout = self.retry_policy.attempt_timeout_s or self.timeout_s
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read() or b"{}")

    @staticmethod
    def _route(path: str) -> str:
        """Normalize a request path to its route TEMPLATE for breaker and
        metric keying: raw per-object paths (/api/pods/<name>, .../bind)
        would mint one breaker + one metric series per object — unbounded
        growth, and per-object breakers see ~1 call each so they could
        never accumulate enough consecutive failures to open. Delegates to
        the apiserver's canonical ``route_template`` so client-side keys and
        server-side span names can never drift apart."""
        from .apiserver import route_template

        return route_template(path)

    def _call(self, method: str, path: str, body: Optional[Dict] = None) -> Dict:
        """Transport with retries + per-endpoint breaker. 5xx/connection
        failures retry with jittered backoff; 4xx (admission, not-found,
        conflicts) are terminal and surface immediately. NOTE on writes:
        a retried POST/PUT whose first attempt actually landed replays as an
        idempotent per-object-version no-op on the server side (the same
        guard that absorbs watch echoes)."""
        endpoint = self._route(path)
        # the watch long-poll is exempt from the breaker: it is a single
        # self-paced consumer (the watch loop already backs off between
        # reconnects), and an open circuit would delay post-restart resync
        # by the whole recovery window for no protective benefit
        breaker = None if endpoint == "/watch" else self.breakers.get(endpoint)
        try:
            # client span per call: retries/breaker trips from the resilience
            # layer land on it as events, and its traceparent is what the
            # transport injects — the span that crosses the wire. The watch
            # long-poll is exempt (like it is from the breaker): it fires
            # every few seconds forever, and each poll would mint a fresh
            # single-span trace that churns real reconcile traces out of the
            # tracer's bounded per-trace index.
            if endpoint == "/watch":
                span_ctx = contextlib.nullcontext()
            else:
                span_ctx = tracing.TRACER.span(
                    f"apiserver.client.{method} {endpoint}"
                )
            with span_ctx:
                return resilient_call(
                    lambda: self._transport(method, path, body),
                    policy=self.retry_policy,
                    breaker=breaker,
                    service="apiserver",
                    endpoint=endpoint,
                )
        except CircuitOpenError as e:
            raise RuntimeError(f"{method} {path}: {e}") from e
        except urllib.error.HTTPError as e:
            payload = {}
            try:
                payload = json.loads(e.read() or b"{}")
            except Exception:
                pass
            if e.code == 422 and payload.get("admission"):
                raise AdmissionError(
                    payload.get("kind", "object"),
                    payload.get("name", "?"),
                    payload.get("fieldErrors", [payload.get("error", "rejected")]),
                )
            raise RuntimeError(
                f"{method} {path}: HTTP {e.code}: {payload.get('error', '')}"
            ) from e

    # -- informer cache ------------------------------------------------------
    def relist(self) -> None:
        """List-and-replace sync (initial sync and watch-gone recovery),
        DELTA-AWARE: the server's per-kind versions (``/version``
        kindVersions) let a recovery skip every kind that saw no writes
        since the last relist — a reconnect storm against a quiet cluster
        then costs one /version round-trip, not six full lists. The watch
        bookmark is the server version read BEFORE the lists: writes landing
        between the per-kind lists replay as watch events and the per-object
        version guard in ``_apply_wire`` makes the replay idempotent — a
        max-across-lists bookmark would skip events for kinds listed early
        Ends by emitting a ``RESYNCED`` event (obj=None)
        when anything was re-listed, so incremental consumers (the encoder's
        dirty-set session) know individual events may have been skipped."""
        version_info = self._call("GET", "/version")
        bookmark = version_info.get("watchSeq", 0)
        kind_versions = version_info.get("kindVersions", None)
        # adopt the serving incarnation: per-kind versions stay trustworthy
        # across a listener restart (they come from the surviving store),
        # and the bookmark below is re-read from THIS incarnation's log
        with self._lock:
            self._server_incarnation = version_info.get("incarnation")
        relisted = False
        try:
            for kind, attr in _COLLECTION_ATTR.items():
                if kind_versions is not None:
                    server_v = kind_versions.get(kind, 0)
                    if self._kind_seen.get(kind) == server_v:
                        continue  # no writes since our last list of this kind
                path = f"/api/{kind}"
                if self.cell is not None and kind in CellIndex.FILTERABLE:
                    path += f"?cell={urllib.parse.quote(self.cell)}"
                out = self._call("GET", path)
                decode = KINDS[kind][2]
                relisted = True
                with self._lock:
                    coll = getattr(self, attr)
                    coll.clear()
                    for item in out["items"]:
                        obj = decode(item)
                        coll[obj.meta.name] = obj
                    if kind_versions is not None:
                        self._kind_seen[kind] = kind_versions.get(kind, 0)
            with self._lock:
                self._bookmark = bookmark
                self._version = max(
                    self._version, version_info.get("resourceVersion", 0)
                )
        finally:
            # in a finally: a PARTIAL relist (a later kind's list failed
            # mid-loop) has already replaced earlier kinds' caches wholesale
            # — incremental consumers must hear about it even though the
            # relist will be retried, or their dirty-set state goes stale
            # against the half-swapped cache
            if relisted:
                self._emit("RESYNCED", None)

    def _apply_wire(self, version: int, event: str, kind: str, wire: Dict) -> None:
        """Apply one remote event to the cache, idempotently, and fire the
        local watch callbacks (the informer handlers). Staleness is judged
        PER OBJECT (event version vs the cached object's version): the relist
        bookmark can replay events the lists already reflect, and a
        read-your-writes echo arrives with the version the write stamped —
        both must no-op without suppressing unrelated events."""
        decode = KINDS[kind][2]
        attr = _COLLECTION_ATTR[kind]
        name = wire["meta"]["name"]
        with self._lock:
            if version > self._version:
                self._version = version
            deferred = self._inflight.get((kind, name))
            if deferred is not None:
                # a local write to this object is in flight: defer (replayed
                # by the write path once its own cache apply lands)
                deferred.append((version, event, kind, wire))
                return
            coll = getattr(self, attr)
            existing = coll.get(name)
            if existing is not None and existing.meta.resource_version >= version:
                return  # cache already at or past this event
            if event == "DELETED":
                if existing is None:
                    return  # already gone (self-applied delete, or relisted)
                coll.pop(name)
                obj = existing
            else:
                obj = decode(wire)
                coll[name] = obj
        if kind == "pods":
            # lifecycle intake at the applier — the earliest boundary a
            # pending pod crosses in this process (the controller callback
            # stamps it too, but first-seen wins); a delete before bind
            # retires its in-flight waterfall immediately
            from ..utils.lifecycle import LIFECYCLE

            if event == "DELETED":
                LIFECYCLE.discard(name)
            elif obj.is_pending() and obj.meta.deletion_timestamp is None:
                LIFECYCLE.intake(name)
        self._emit(event, obj)

    def _watch_loop(self) -> None:
        """Informer watch with server-restart survival: failures reconnect on
        the shared RetryPolicy's backoff schedule (the _call-level retries
        already absorbed the transient window), logging ONCE at WARN when the
        watch first disconnects — not per iteration — then at DEBUG until it
        recovers. A rejected bookmark (server "gone", k8s 410 semantics)
        falls back to a full relist, which also re-reads the bookmark.

        This thread only FETCHES: events land on the bounded intake queue
        and the applier thread applies them (see __init__). ``limit=`` caps
        each poll at the queue capacity so one response can never exceed the
        intake bound on its own."""
        failures = 0
        while not self._stop.is_set():
            try:
                cell_q = (
                    f"&cell={urllib.parse.quote(self.cell)}"
                    if self.cell is not None
                    else ""
                )
                out = self._call(
                    "GET",
                    f"/watch?since={self._bookmark}&timeout=5"
                    f"&limit={self.queue_capacity}{cell_q}",
                )
                if out.get("gone"):
                    # bookmark rejected: full resync, serialized onto the
                    # applier thread so it cannot interleave with applies
                    self._request_relist()
                    continue
            except Exception as e:
                failures += 1
                delay = self.retry_policy.backoff(min(failures - 1, 8))
                level = logging.WARNING if failures == 1 else logging.DEBUG
                kv(self._log, level, "watch disconnected; reconnecting",
                   failures=failures, delay_s=round(delay, 3),
                   error=f"{type(e).__name__}: {e}")
                if self._stop.wait(delay):
                    return
                continue
            if failures:
                kv(self._log, logging.INFO, "watch reconnected",
                   after_failures=failures)
                failures = 0
            incarnation = out.get("incarnation")
            if (
                incarnation is not None
                and self._server_incarnation is not None
                and incarnation != self._server_incarnation
            ):
                # restarted listener whose fresh log caught up past our
                # stale bookmark: the seqs LOOK resumable but belong to a
                # different history — only a relist is safe (it also adopts
                # the new incarnation)
                kv(self._log, logging.WARNING,
                   "apiserver incarnation changed; relisting",
                   old=self._server_incarnation, new=incarnation)
                self._request_relist()
                continue
            events = out.get("events", ())
            if events:
                self._enqueue_events(events)
            # bookmarks advance at FETCH time, not apply time: shed (the
            # only path that loses queued events) always relists, which
            # re-reads the bookmark — so a fetched-then-shed event can
            # never be silently skipped. The server's bookmark covers the
            # filtered-out tail of a per-cell stream (and equals the last
            # event seq otherwise).
            with self._lock:
                for ev in events:
                    self._bookmark = max(self._bookmark, ev["seq"])
                self._bookmark = max(self._bookmark, out.get("bookmark", 0))

    # -- bounded intake + applier (backpressure) ----------------------------
    def _enqueue_events(self, events) -> None:
        with self._intake_cv:
            if len(self._intake) + len(events) > self.queue_capacity:
                # overflow: the consumer is hopelessly behind — grinding
                # through the backlog would cost more than a relist and the
                # queue must not grow without bound. Shed EVERYTHING
                # (bookmarks already advanced past these events) and let the
                # applier rebuild the cache from a list.
                shed = len(self._intake) + len(events)
                metrics.BACKPRESSURE_EVENTS.inc({"action": "shed"}, value=shed)
                kv(self._log, logging.WARNING,
                   "watch intake overflow; shedding queue and relisting",
                   shed=shed, capacity=self.queue_capacity)
                self._intake.clear()
                self._intake.append(_RELIST)
            else:
                self._intake.extend(events)
            self._intake_cv.notify_all()

    def _request_relist(self) -> None:
        """Enqueue a relist marker and wait until the applier ran it, so the
        watch thread's next poll reads the refreshed bookmark."""
        with self._intake_cv:
            gen = self._relist_gen
            self._intake.append(_RELIST)
            self._intake_cv.notify_all()
            while self._relist_gen == gen and not self._stop.is_set():
                self._intake_cv.wait(0.5)

    def _apply_loop(self) -> None:
        """Single consumer of the intake queue: applies remote events (and
        runs queued relists) in arrival order. Under sustained lag — the
        drained batch repeatedly above half the queue bound — it WIDENS the
        apply batch window: waits a short accumulate window, then coalesces
        the batch to the newest event per object before applying, trading
        per-event callback latency for bounded work (the per-object version
        guard makes dropping superseded intermediates safe; every consumer
        of these callbacks keys on final object state)."""
        while True:
            with self._intake_cv:
                while (
                    not self._intake or self._quiesced > 0
                ) and not self._stop.is_set():
                    self._intake_cv.wait(0.5)
                if self._stop.is_set() and not self._intake:
                    return
            if self._widened:
                # widened window: let the storm accumulate so one coalesced
                # apply replaces many tiny ones
                self._stop.wait(_WIDEN_WINDOW_S)
            with self._intake_cv:
                if self._quiesced > 0 and not self._stop.is_set():
                    continue  # a round began while we slept: hold the batch
                batch = list(self._intake)
                self._intake.clear()
                n_events = sum(1 for item in batch if item is not _RELIST)
                if n_events >= self.queue_capacity * _WIDEN_HIGH_FRAC:
                    self._lag_streak += 1
                    if self._lag_streak >= _WIDEN_AFTER and not self._widened:
                        self._widened = True
                        kv(self._log, logging.WARNING,
                           "sustained watch lag; widening apply batch window",
                           batch=n_events, capacity=self.queue_capacity)
                else:
                    self._lag_streak = 0
                    self._widened = False
                self._applying = True
            try:
                self._apply_batch(batch)
            finally:
                with self._intake_cv:
                    self._applying = False
                    self._intake_cv.notify_all()

    def _apply_batch(self, batch) -> None:
        pending: list = []
        for item in batch:
            if item is _RELIST:
                self._apply_events(pending)
                pending = []
                try:
                    self.relist()
                except Exception as e:
                    # The relist must eventually HAPPEN, not just be
                    # attempted: on the shed path the bookmark already
                    # advanced past the dropped events, so a failed relist
                    # with no retry would silently lose them forever (the
                    # gone/incarnation paths re-request on the next poll;
                    # shed has no such second chance). Re-enqueue the
                    # marker — the brief wait keeps a persistently-down
                    # server from hot-spinning the applier.
                    kv(self._log, logging.WARNING,
                       "queued relist failed; will retry",
                       error=f"{type(e).__name__}: {e}")
                    with self._intake_cv:
                        self._intake.append(_RELIST)
                    self._stop.wait(0.5)
                # bump the gen either way: a _request_relist waiter must not
                # deadlock on a relist that cannot succeed yet (the retry
                # marker above owns eventual completion)
                with self._intake_cv:
                    self._relist_gen += 1
                    self._intake_cv.notify_all()
            else:
                pending.append(item)
        self._apply_events(pending)

    def _apply_events(self, events) -> None:
        if not events:
            return
        if self._widened and len(events) > 1:
            # coalesce superseded intermediates to the newest event per
            # (kind, name) — but NEVER across a DELETED edge: a
            # delete-then-recreate collapsed to the final ADDED would drop
            # the delete edge that edge-triggered consumers key on (the
            # provisioning arrival-dedup set would then swallow the new
            # pod's batch-window arm). A DELETED terminates the object's
            # merge slot; later events for the name start a fresh one.
            out: list = []
            slot: Dict[tuple, int] = {}
            for ev in events:
                key = (ev["kind"], ev["object"]["meta"]["name"])
                if ev["event"] == "DELETED":
                    out.append(ev)
                    slot.pop(key, None)
                    continue
                idx = slot.get(key)
                if idx is None:
                    slot[key] = len(out)
                    out.append(ev)
                else:
                    out[idx] = ev
            dropped = len(events) - len(out)
            if dropped:
                metrics.BACKPRESSURE_EVENTS.inc(
                    {"action": "widen"}, value=dropped
                )
            events = out
        for ev in events:
            self._apply_wire(
                ev["resourceVersion"], ev["event"], ev["kind"], ev["object"]
            )

    @contextlib.contextmanager
    def quiesce(self):
        """Pause remote-event application for one reconcile round: the
        flight recorder's input capture and the encoder's cluster reads must
        see ONE view, or a watch event landing between them makes the
        capsule's recorded digest irreproducible offline (false DIVERGED —
        the soak's churn hit this constantly). Events keep FETCHING into the
        bounded intake queue (backpressure still governs overflow); only
        application waits. Re-entrant; releasing wakes the applier."""
        with self._intake_cv:
            self._quiesced += 1
            # wait out a batch the applier already popped: its events would
            # otherwise keep landing after this round thinks the view froze
            while self._applying and not self._stop.is_set():
                self._intake_cv.wait(0.5)
        try:
            yield
        finally:
            with self._intake_cv:
                self._quiesced -= 1
                self._intake_cv.notify_all()

    def close(self) -> None:
        self._stop.set()
        with self._intake_cv:
            self._intake_cv.notify_all()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=6)
        if self._apply_thread is not None:
            self._apply_thread.join(timeout=6)

    # -- writes (server first, then read-your-writes cache apply) ------------
    class _InFlight:
        def __init__(self, cluster: "HTTPCluster", kind: str, name: str):
            self.cluster, self.key = cluster, (kind, name)

        def __enter__(self):
            with self.cluster._lock:
                self.cluster._inflight.setdefault(self.key, [])

        def __exit__(self, *exc):
            with self.cluster._lock:
                deferred = self.cluster._inflight.pop(self.key, [])
            # replay events that arrived mid-write: the self-echo no-ops on
            # the per-object version guard; a concurrent third-party write
            # (higher version) applies — nothing is lost
            for version, event, kind, wire in deferred:
                self.cluster._apply_wire(version, event, kind, wire)

    def _create(self, obj):
        """POST to the server, then cache the CALLER'S instance (not the
        server's decoded copy): controllers mutate objects they hold after
        adding them — machine status flags during registration, node flips —
        exactly as the in-process store allows, and the cache must alias
        those instances or HTTP-mode state silently diverges. Defaulted
        fields the server's admission added are folded back in."""
        kind = kind_of(obj)
        with self._InFlight(self, kind, obj.meta.name):
            try:
                stored = self._call("POST", f"/api/{kind}", to_wire(obj))
            except RuntimeError as e:
                if "HTTP 409" not in str(e):
                    raise
                # POST is strict CREATE on the wire now (409 AlreadyExists):
                # an add_* over an existing name — a transport retry whose
                # first attempt landed, or a caller re-adding — replays as
                # the replace it semantically is, so HTTPCluster's upsert
                # surface is unchanged
                stored = self._call(
                    "PUT", f"/api/{kind}/{obj.meta.name}", to_wire(obj)
                )
            decoded = KINDS[kind][2](stored)
            if kind in ("provisioners", "nodetemplates"):
                # admission defaulting ran server-side; adopt the stored spec
                obj.__dict__.update(decoded.__dict__)
            version = stored["meta"]["resourceVersion"]
            obj.meta.resource_version = version
            with self._lock:
                getattr(self, _COLLECTION_ATTR[kind])[obj.meta.name] = obj
                self._version = max(self._version, version)
        self._emit("ADDED", obj)
        return obj

    def add_pod(self, pod: Pod) -> Pod:
        return self._create(pod)

    def add_node(self, node: Node) -> Node:
        return self._create(node)

    def add_machine(self, machine: Machine) -> Machine:
        return self._create(machine)

    def add_provisioner(self, provisioner: Provisioner) -> Provisioner:
        return self._create(provisioner)

    def add_node_template(self, t: NodeTemplate) -> NodeTemplate:
        return self._create(t)

    def add_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        return self._create(pdb)

    def update(self, obj) -> None:
        kind = kind_of(obj)
        with self._InFlight(self, kind, obj.meta.name):
            try:
                stored = self._call(
                    "PUT", f"/api/{kind}/{obj.meta.name}", to_wire(obj)
                )
            except RuntimeError as e:
                if "HTTP 404" not in str(e):
                    raise
                # PUT is strict REPLACE on the wire now (404 on a missing
                # name): an update racing a server-side delete falls back to
                # create, preserving this client's historical upsert
                # behavior for callers that re-announce objects they hold
                stored = self._call("POST", f"/api/{kind}", to_wire(obj))
            # keep the CALLER'S object authoritative in the cache: controllers
            # mutate objects they hold and expect those instances to stay live
            # (the same contract as the in-process store). Only the version
            # advances from the server's stored copy.
            with self._lock:
                version = stored["meta"]["resourceVersion"]
                obj.meta.resource_version = version
                if isinstance(obj, (Pod, Node)):
                    obj.invalidate_scheduling_cache()
                getattr(self, _COLLECTION_ATTR[kind])[obj.meta.name] = obj
                self._version = max(self._version, version)
        self._emit("MODIFIED", obj)

    def _remote_delete(self, kind: str, name: str):
        with self._InFlight(self, kind, name):
            try:
                out = self._call("DELETE", f"/api/{kind}/{name}")
            except RuntimeError as e:
                if "HTTP 404" in str(e):
                    return None
                raise
            with self._lock:
                obj = getattr(self, _COLLECTION_ATTR[kind]).pop(name, None)
                self._version = max(self._version, out["meta"]["resourceVersion"])
        if obj is not None:
            self._emit("DELETED", obj)
        return obj

    def delete_pod(self, name: str) -> Optional[Pod]:
        return self._remote_delete("pods", name)

    def delete_node(self, name: str) -> Optional[Node]:
        return self._remote_delete("nodes", name)

    def delete_machine(self, name: str) -> Optional[Machine]:
        return self._remote_delete("machines", name)

    def delete_provisioner(self, name: str) -> Optional[Provisioner]:
        return self._remote_delete("provisioners", name)

    def bind_pod(self, pod_name: str, node_name: str) -> None:
        with self._InFlight(self, "pods", pod_name):
            out = self._call(
                "POST", f"/api/pods/{pod_name}/bind", {"nodeName": node_name}
            )
            with self._lock:
                pod = self.pods.get(pod_name)
                if pod is not None:
                    pod.node_name = node_name
                    pod.phase = "Running"
                    version = out["meta"]["resourceVersion"]
                    pod.meta.resource_version = version
                    self._version = max(self._version, version)
        if pod is not None:
            self._emit("MODIFIED", pod)
