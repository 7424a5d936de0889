"""Reconcile flight recorder: capture whole rounds, replay them offline.

A copy of ``karpenter_tpu/utils/flightrecorder.py``. The one difference is
noted at :meth:`CapsuleBuilder.add_digest`: the port's solver has no
executable cache, so a capsule's ``aot_solves`` never appears.

The decision audit log answers *what* the controllers decided and the
metrics/traces answer *how long it took* — but when an operator sees a bad
placement or a consolidation that should have fired, nothing lets them re-run
that exact round and step through it. This module closes the loop with a
bounded in-process ring of per-reconcile **capsules**: each captures the
complete round input — the cluster state snapshot at that resourceVersion,
the instance-type/offering lists the round actually solved against
(offering ``available`` flags embed the ICE-cache mask at capture time), the
active settings, the encode-canonical batch order, reconcile_id + trace_id —
plus the recorded outputs (per-solve problem digests, placements, actions,
the round's DecisionRecords, any error).

The session's equivalence contract makes the capture sufficient: a
round's encode is digest-identical to a from-scratch encode of its
canonical inputs, so ``python -m karpenter_tpu_torch.replay <capsule>``
reconstructs the cluster from the capsule, re-runs the real solver with no
network, and diffs replayed digests/placements/verdicts byte-for-byte
against the recorded ones.

Capsules are exported at ``/debug/flightrecorder`` (list) and
``/debug/flightrecorder/<id>`` (one gzip'd JSON capsule), and dumped to disk
on demand (``?dump=1``) or automatically on anomaly triggers: reconcile
error, unschedulable pods, a full-encode fallback, or a circuit breaker
opening mid-round.

Capture rides the reconcile hot path, so it is delta-aware like the encoder:
wire dicts are cached per object ``(kind, name, resourceVersion)`` (weakly
keyed by cluster, so test clusters don't cross-contaminate) and instance-type
wire lists are cached by list identity (the provider's seqnum caches return
the same list object until something changes). A steady-state round
serializes only what churned, though it still walks every object of the
cluster. ``chip_smoke.py`` logs the capture's seconds
(``FLIGHTRECORDER_CAPTURE``) beside each controller round's wall.
"""

from __future__ import annotations

import dataclasses
import gzip
import itertools
import json
import os
import re
import threading
import time
import weakref
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from . import metrics
from .decisions import tee_decisions
from .logging import context_fields
from .tracing import current_trace_id

#: anomaly trigger names (the dump-to-disk reasons)
TRIGGER_ERROR = "reconcile-error"
TRIGGER_UNSCHEDULABLE = "unschedulable-pods"
TRIGGER_FULL_ENCODE = "full-encode-fallback"
TRIGGER_BREAKER = "breaker-open"
TRIGGER_GANG_DEFERRED = "gang-deferred"
TRIGGER_VALIDATION = "validation-rejected"
TRIGGER_PERF_REGRESSION = "perf-regression"

#: full-encode reasons that are NORMAL operation, not an anomaly: the first
#: encode of a session, the periodic backstop, and a disabled delta path
_BENIGN_FULL_REASONS = ("", "first-encode", "periodic-resync", "disabled")

_capsule_seq = itertools.count(1)
_SAFE_ID = re.compile(r"[^A-Za-z0-9._-]+")

#: thread-local recording suppression: the replay harness re-runs controllers
#: that would otherwise record capsules OF the replay into the live ring
_suppress = threading.local()


class suppressed:
    """Context manager disabling capsule capture on this thread."""

    def __enter__(self):
        self._prev = getattr(_suppress, "on", False)
        _suppress.on = True
        return self

    def __exit__(self, *exc):
        _suppress.on = self._prev
        return False


def _settings_to_wire(settings) -> Dict:
    try:
        return dataclasses.asdict(settings)
    except TypeError:
        return {k: v for k, v in vars(settings).items() if not k.startswith("_")}


class CapsuleBuilder:
    """Accumulates one reconcile's capsule; handed out by
    :meth:`FlightRecorder.begin` (``None`` when recording is disabled, so
    controllers guard with ``if cap is not None``)."""

    def __init__(self, recorder: "FlightRecorder", controller: str):
        self._recorder = recorder
        self.controller = controller
        # tee, not a ring read-back: a round emitting more records than the
        # ring's capacity must still capsule EVERY one of its decisions
        # (replay's ICE pre-seed reads ice-failed nominations from here)
        self._decision_tee = tee_decisions().__enter__()
        from .resilience import breaker_open_count

        self._breaker_open0 = breaker_open_count()
        self._inputs: Optional[Dict] = None
        self._outputs: Dict = {}
        self._digests: List[str] = []
        # per-digest executable-cache record ({bucket, hit} or None for
        # host-backend / untracked solves), aligned with _digests
        self._aot: List[Optional[Dict]] = []
        self._batch_order: Optional[List[str]] = None
        # the round's completed pod-lifecycle waterfalls (utils/lifecycle.py)
        # — forensic output like aot_solves, excluded from every replay
        # comparison (a replay re-runs under lifecycle suppression and
        # cannot reproduce wall-clock timings)
        self._lifecycle: List[Dict] = []
        self._anomalies: List[str] = []
        self._meta: Dict = {}
        self._finished = False

    # -- input capture ------------------------------------------------------
    def capture_inputs(
        self,
        cluster,
        provisioner_types: Sequence[Tuple[object, Sequence[object]]] = (),
        settings=None,
        provider=None,
        solver=None,
        clock_now: Optional[float] = None,
        extra: Optional[Dict] = None,
    ) -> None:
        """Snapshot the round's complete input BEFORE the reconcile mutates
        anything: all stored objects (wire-encoded, version-cached), the
        instance-type lists the round solves against (per provisioner, ICE
        masks baked into offering availability), the active settings, and
        the deprovisioner's clock."""
        t0 = time.perf_counter()
        from ..api import codec

        # one consistent locked read of EVERY kind, and serialization under
        # the same store lock: the HTTP informer's watch thread applies
        # events in place, and a capsule torn mid-capture would replay a
        # cluster the recorded round never saw (false DIVERGED verdicts)
        with cluster._lock:
            snap = cluster.state_snapshot()
            cache = self._recorder._wire_cache(cluster)
            seen: set = set()
            objects = {
                "pods": _wire_objects(cache, "pods", snap.pods, codec.pod_to_wire, seen),
                "nodes": _wire_objects(
                    cache, "nodes", snap.nodes, codec.node_to_wire, seen
                ),
                "machines": _wire_objects(
                    cache, "machines", snap.machines, codec.machine_to_wire, seen
                ),
                "provisioners": _wire_objects(
                    cache, "provisioners", snap.provisioners,
                    codec.provisioner_to_wire, seen,
                ),
                "nodetemplates": _wire_objects(
                    cache, "nodetemplates", snap.node_templates,
                    codec.node_template_to_wire, seen,
                ),
                "poddisruptionbudgets": _wire_objects(
                    cache, "poddisruptionbudgets", snap.pdbs, codec.pdb_to_wire,
                    seen,
                ),
            }
        if len(cache) > len(seen):
            # deleted objects leave the cache with the snapshot that no
            # longer names them (committed capsules keep their wire refs)
            for key in [k for k in cache if k not in seen]:
                del cache[key]
        instance_types = {
            prov.name: self._recorder._wire_instance_types(prov.name, types)
            for prov, types in provisioner_types
        }
        # forensic context, not a replay input: the round's catalog already
        # carries the mask as offering availability — this names WHICH
        # offerings were masked, so an operator picking a counterfactual
        # (--override offerings=...=available) doesn't have to diff catalogs
        ice = getattr(provider, "unavailable_offerings", None)
        self._inputs = {
            "settings": _settings_to_wire(settings) if settings is not None else {},
            "objects": objects,
            "instance_types": instance_types,
            "ice_entries": [list(e) for e in ice.entries()] if ice is not None else [],
        }
        self._meta["resource_version"] = snap.resource_version
        # upcoming machine-name index: nodes launched MID-round enter later
        # solve rounds' digests by name, so replay must mint the same names
        from ..controllers.provisioning import _machine_ids

        self._meta["machine_seq"] = _machine_ids.peek()
        if solver is not None:
            self._meta["solver"] = type(solver).__name__
        if clock_now is not None:
            self._meta["clock_now"] = clock_now
        if extra:
            self._inputs.update(extra)
        metrics.FLIGHTRECORDER_CAPTURE.observe(time.perf_counter() - t0)

    @property
    def captured(self) -> bool:
        return self._inputs is not None

    @property
    def anomalies(self) -> List[str]:
        return list(self._anomalies)

    def set_batch_order(self, names: Sequence[str]) -> None:
        """The encode-canonical pod order of the round's batch
        (``EncodeSession.ordered_pods``): replay feeds pods back in exactly
        this order so its from-scratch full encode is digest-identical to the
        recorded (possibly delta) encode: the session's equivalence contract."""
        self._batch_order = list(names)

    def add_digest(self, digest_hex: str, stats: Optional[Dict] = None) -> None:
        """One per solver round (the pool cascade / ICE re-solves may run
        several); byte-compared against the replayed sequence. ``stats`` (the
        SolveResult's) additionally records the executable-cache bucket the
        kernel dispatched on and whether it was resident — forensics for the
        cold-solve story, NEVER part of the replay match verdict: a replaying
        process may hit or cold-compile the bucket and must produce the same
        bytes either way.

        The port's ``TorchSolver`` has no executable cache and stamps
        neither ``aot_bucket`` nor ``aot_hit``, so every entry here is
        ``None`` and the capsule carries no ``aot_solves``; the field stays
        for a solver that does stamp them."""
        if digest_hex:
            self._digests.append(digest_hex)
            aot = None
            if stats is not None and (
                "aot_bucket" in stats or "aot_hit" in stats
            ):
                aot = {
                    "bucket": stats.get("aot_bucket"),
                    "hit": bool(stats["aot_hit"]) if "aot_hit" in stats else None,
                }
                if "fleet_b" in stats:
                    # fleet width: this solve's kernel answer came from row
                    # b of a batched (vmapped) device call shared with
                    # fleet-1 sibling cells — forensics for the dispatch-
                    # count story, like bucket/hit never a replay input
                    aot["fleet"] = int(stats["fleet_b"])
            self._aot.append(aot)

    def note_anomaly(self, trigger: str) -> None:
        if trigger not in self._anomalies:
            self._anomalies.append(trigger)

    def note_cells(self, round_cells: List[Dict]) -> None:
        """The capsule's cell axis: one entry per sharded solve round with
        the per-cell summaries (cell id/name, pod count, problem digest,
        encode mode, cost). Captured from the round's already-merged state
        under the controller's single solve epoch, so replaying the capsule
        re-derives the same partition and the same per-cell digests."""
        self._meta.setdefault("cells", []).append(list(round_cells))

    def note_encode_mode(self, mode: str, reason: str) -> None:
        """Record the session's encode mode for the round; a full-encode
        FALLBACK (any reason beyond first-encode/periodic/disabled) is an
        anomaly trigger — the delta path lost track of the cluster."""
        self._meta["encode_mode"] = mode
        if reason:
            self._meta["encode_full_reason"] = reason
        if mode == "full" and reason not in _BENIGN_FULL_REASONS:
            self.note_anomaly(TRIGGER_FULL_ENCODE)

    # -- output capture -----------------------------------------------------
    def set_outputs_provisioning(self, result, cluster, pricing=None) -> None:
        """Provisioning outputs: per-pod placements (with the chosen offering
        for new nodes — machine names differ across replays, offerings must
        not), launched node specs, the unschedulable set, and — when a price
        book is supplied — the round's cost delta (a pure function of the
        launched offerings and the capsule-visible prices, so replay
        reproduces it byte-identically and ``--override offerings=...=price:``
        answers what the round would have cost at counterfactual prices)."""
        self._outputs.update(provisioning_outputs(result, cluster, pricing))
        if result.unschedulable:
            self.note_anomaly(TRIGGER_UNSCHEDULABLE)

    def set_lifecycle_marks(self, records: List[Dict]) -> None:
        """The round's completed lifecycle waterfalls (pod, per-stage
        durations, e2e, backend) — the forensic 'where did this pod's
        latency go' answer attached to the capsule that placed it."""
        self._lifecycle = list(records)

    def set_outputs_rebalance(self, actions: List[Dict]) -> None:
        """Rebalance-round outputs: the ordered action list (replacement
        launches, gated drains, deadline fallbacks) with pool + replacement
        offering identity — node names replay identically because the
        machine-name sequence is pinned like provisioning's."""
        self._outputs["rebalance_actions"] = list(actions)

    def set_outputs_action(self, executed, planned=None) -> None:
        """Deprovisioning outputs: the action executed this pass and/or the
        plan parked for the validation TTL (offering triples for
        replacements — machine names are not replayable identity)."""
        self._outputs["action"] = action_to_wire(executed)
        self._outputs["planned"] = action_to_wire(planned)

    # -- commit -------------------------------------------------------------
    def finish(self, error: Optional[BaseException] = None) -> Optional[Dict]:
        """Assemble and commit the capsule. Rounds that captured nothing and
        saw no error are dropped — idle ticks must not churn real capsules
        out of the ring. Returns the committed capsule dict (or None)."""
        if self._finished:
            return None
        self._finished = True
        self._decision_tee.__exit__(None, None, None)
        from .resilience import breaker_open_count

        if breaker_open_count() > self._breaker_open0:
            self.note_anomaly(TRIGGER_BREAKER)
        if error is not None:
            self.note_anomaly(TRIGGER_ERROR)
        if self._inputs is None and error is None:
            return None
        reconcile_id = str(context_fields().get("reconcile_id", ""))
        capsule_id = reconcile_id or f"{self.controller}.fr{next(_capsule_seq)}"
        capsule = {
            "id": capsule_id,
            "controller": self.controller,
            "reconcile_id": reconcile_id,
            "trace_id": current_trace_id(),
            "timestamp": time.time(),
            **self._meta,
            "anomalies": list(self._anomalies),
            "inputs": self._inputs if self._inputs is not None else {},
            "outputs": {
                **self._outputs,
                "problem_digests": list(self._digests),
                # executable-cache forensics (bucket + hit/miss per solve);
                # absent when no solve carried AOT stats, and excluded from
                # every replay comparison — cache state is not an input
                **(
                    {"aot_solves": list(self._aot)}
                    if any(a is not None for a in self._aot)
                    else {}
                ),
                # lifecycle waterfalls: forensic like aot_solves, excluded
                # from every replay comparison — wall-clock is not an input
                **({"lifecycle": list(self._lifecycle)} if self._lifecycle else {}),
                "decisions": [r.to_dict() for r in self._decision_tee.records],
                "error": f"{type(error).__name__}: {error}" if error else None,
            },
        }
        if self._batch_order is not None:
            capsule["inputs"]["batch_order"] = self._batch_order
        self._recorder._commit(capsule, self._anomalies)
        return capsule


def _wire_objects(cache: Dict, kind: str, objs, to_wire, seen: set) -> List[Dict]:
    """Wire-encode a kind's objects through the version-keyed cache: only
    objects whose ``resource_version`` moved since the last capture pay the
    serialization; everything else is a dict ref share (wire dicts are
    immutable once built — every consumer treats capsules as read-only)."""
    out: List[Dict] = []
    for o in objs:
        key = (kind, o.meta.name)
        seen.add(key)
        ver = o.meta.resource_version
        ent = cache.get(key)
        if ent is None or ent[0] != ver:
            ent = (ver, to_wire(o))
            cache[key] = ent
        out.append(ent[1])
    return out


def provisioning_outputs(result, cluster, pricing=None) -> Dict:
    """Replay-comparable view of a ProvisioningResult: per-pod placements —
    EXISTING-node binds compare by node name (the node is capsule input),
    new-node binds by the chosen offering triple (machine names are fresh
    every process) — plus the launched specs and the unschedulable set.
    Shared by capsule capture and the replay harness so the two sides can
    never diverge in shape. ``pricing`` (a PricingProvider — live at
    capture, capsule-catalog-backed on replay) adds the round's cost delta
    via ``costledger.round_cost_delta``, the ledger's pure per-round spend
    function."""
    from ..api import labels as wk

    cost_delta = None
    if pricing is not None:
        from .costledger import round_cost_delta

        cost_delta = round_cost_delta(result.nodes, pricing)
    new_node_names = {n.meta.name for n in result.nodes}
    nodes_by_name = {n.meta.name: n for n in result.nodes}
    placements: Dict[str, Dict] = {}
    for pod, node in result.bound.items():
        entry: Dict = {"node": node, "existing": node not in new_node_names}
        obj = nodes_by_name.get(node) or cluster.nodes.get(node)
        if obj is not None:
            entry["instance_type"] = obj.meta.labels.get(wk.INSTANCE_TYPE, "")
            entry["zone"] = obj.meta.labels.get(wk.ZONE, "")
            entry["capacity_type"] = obj.meta.labels.get(wk.CAPACITY_TYPE, "")
        placements[pod] = entry
    return {
        "placements": placements,
        # None when no price book was supplied (pre-ledger capsules and
        # callers without a provider) — replay skips the comparison then
        "cost_delta": cost_delta,
        "unschedulable": sorted(set(result.unschedulable)),
        "gang_deferred": sorted(set(getattr(result, "gang_deferred", []) or [])),
        # validation-firewall evaluations in call order (verdict, backend,
        # violations): replay installs this sequence as scripted verdicts —
        # a rejection caused by a transient device fault cannot be
        # recomputed offline, but its downstream fallback decision must
        # still replay byte-identically — and the match verdict compares it
        "validation_events": list(
            getattr(result, "validation_events", []) or []
        ),
        "new_nodes": [
            {
                "name": m.meta.name,
                "instance_type": m.meta.labels.get(wk.INSTANCE_TYPE, ""),
                "zone": m.meta.labels.get(wk.ZONE, ""),
                "capacity_type": m.meta.labels.get(wk.CAPACITY_TYPE, ""),
            }
            for m in result.machines
        ],
    }


def action_to_wire(action) -> Optional[Dict]:
    """Replay-comparable identity of a PlannedAction: reason, nodes, savings,
    and replacement OFFERING triples (machine names are fresh every process
    and must not enter the comparison)."""
    if action is None:
        return None
    out = {
        "reason": action.reason,
        "nodes": list(action.nodes),
        "savings": round(action.savings, 5),
        "replacements": [
            {
                "instance_type": r.option.instance_type.name,
                "zone": r.option.zone,
                "capacity_type": r.option.capacity_type,
                # enough to RECONSTRUCT the replacement spec offline (the
                # replay's matured-pending-plan path re-validates and
                # executes the recorded plan, not a freshly derived one)
                "provisioner": r.option.provisioner.name,
                "price": r.option.price,
                "pods": len(list(r.pod_names)),
                "pod_names": list(r.pod_names),
            }
            for r in action.replacements
        ],
    }
    # sparse: gang-whole moves record their cross-node evictions + gangs so
    # the matured-plan replay reconstructs them; legacy actions' wire (and
    # every pre-topology capsule comparison) is byte-identical
    if getattr(action, "evict_pods", None):
        out["evict_pods"] = list(action.evict_pods)
    if getattr(action, "gangs", None):
        out["gangs"] = list(action.gangs)
    return out


class FlightRecorder:
    DEFAULT_CAPACITY = 32

    def __init__(self, capacity: int = DEFAULT_CAPACITY, dump_dir: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: Deque[Dict] = deque()
        self._by_id: Dict[str, Dict] = {}
        self.capacity = max(int(capacity), 0)
        self.dump_dir = dump_dir or None
        # per-cluster (weakly keyed) wire caches: (kind, name) -> (version, wire)
        self._wire_caches: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # instance-type wire cache: prov name -> (types list STRONG ref, wire).
        # Identity-compared: the providers' seqnum caches return the same list
        # object until catalog/ICE/pricing state changes, and the held
        # reference keeps ids from being recycled.
        self._it_wire: Dict[str, Tuple[object, List[Dict]]] = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def configure(self, capacity: int, dump_dir: Optional[str] = None) -> None:
        """Resize from settings (``flight_recorder_capacity``); 0 disables
        recording (begin() returns None) and clears retained capsules."""
        with self._lock:
            self.capacity = max(int(capacity), 0)
            self.dump_dir = dump_dir or None
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                self._by_id.pop(old["id"], None)

    # -- recording ----------------------------------------------------------
    def begin(self, controller: str) -> Optional[CapsuleBuilder]:
        """Start one reconcile's capsule. EVERY non-None return must be
        paired with ``finish()`` on the same thread — the builder holds a
        thread-local decision tee until then (the controllers guarantee the
        pairing with try/except BaseException around the reconcile body)."""
        if not self.enabled or getattr(_suppress, "on", False):
            return None
        return CapsuleBuilder(self, controller)

    def _wire_cache(self, cluster) -> Dict:
        with self._lock:
            cache = self._wire_caches.get(cluster)
            if cache is None:
                cache = {}
                self._wire_caches[cluster] = cache
            return cache

    def _wire_instance_types(self, prov_name: str, types) -> List[Dict]:
        from ..cloudprovider.types import instance_type_to_wire

        with self._lock:
            ent = self._it_wire.get(prov_name)
            if ent is not None and ent[0] is types:
                return ent[1]
        wire = [instance_type_to_wire(it) for it in types]
        with self._lock:
            self._it_wire[prov_name] = (types, wire)
        return wire

    def _commit(self, capsule: Dict, anomalies: List[str]) -> None:
        with self._lock:
            if not self.enabled:
                return
            self._ring.append(capsule)
            self._by_id[capsule["id"]] = capsule
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                self._by_id.pop(old["id"], None)
            dump_dir = self.dump_dir
        metrics.FLIGHTRECORDER_CAPSULES.inc({"controller": capsule["controller"]})
        for trigger in anomalies:
            metrics.FLIGHTRECORDER_ANOMALIES.inc({"trigger": trigger})
        if anomalies and dump_dir:
            try:
                self.dump(capsule["id"], dump_dir, trigger="anomaly")
            except OSError:
                pass  # a full/unwritable disk must not fail the reconcile

    def commit_external(self, capsule: Dict) -> None:
        """Admit a capsule assembled OUTSIDE a CapsuleBuilder — the
        federation fleet builds its round capsules by hand (arbiter inputs +
        verdict + per-cluster sub-capsules) and commits them here so they
        ride the same ring, /debug surface, and anomaly auto-dump as
        reconcile capsules. The capsule must carry ``id``, ``controller``
        and (optionally) ``anomalies``."""
        if not self.enabled or getattr(_suppress, "on", False):
            return
        capsule.setdefault("timestamp", time.time())
        capsule.setdefault("anomalies", [])
        self._commit(capsule, list(capsule.get("anomalies", [])))

    # -- export -------------------------------------------------------------
    def list(self) -> List[Dict]:
        """Newest-first capsule summaries (the /debug/flightrecorder list)."""
        with self._lock:
            capsules = list(self._ring)
        out = []
        for c in reversed(capsules):
            out.append({
                "id": c["id"],
                "controller": c["controller"],
                "reconcile_id": c.get("reconcile_id", ""),
                "trace_id": c.get("trace_id", ""),
                "timestamp": round(c.get("timestamp", 0.0), 3),
                "resource_version": c.get("resource_version", 0),
                "anomalies": list(c.get("anomalies", [])),
                "pods": len(c.get("inputs", {}).get("objects", {}).get("pods", [])),
                "digests": len(c.get("outputs", {}).get("problem_digests", [])),
                "decisions": len(c.get("outputs", {}).get("decisions", [])),
            })
        return out

    def get(self, capsule_id: str) -> Optional[Dict]:
        with self._lock:
            return self._by_id.get(capsule_id)

    def get_gzip(self, capsule_id: str) -> Optional[bytes]:
        capsule = self.get(capsule_id)
        if capsule is None:
            return None
        return gzip.compress(json.dumps(capsule, default=str).encode())

    def latest(self, controller: Optional[str] = None) -> Optional[Dict]:
        with self._lock:
            for c in reversed(self._ring):
                if controller is None or c["controller"] == controller:
                    return c
        return None

    @staticmethod
    def _dump_path(capsule_id: str, directory: str) -> str:
        return os.path.join(
            directory, f"capsule-{_SAFE_ID.sub('-', capsule_id)}.json.gz"
        )

    def dump(
        self,
        capsule_id: str,
        dump_dir: Optional[str] = None,
        trigger: str = "manual",
    ) -> Optional[str]:
        """Write one capsule to ``<dir>/capsule-<id>.json.gz``; returns the
        path (None for an unknown id). Raises OSError on unwritable dirs for
        on-demand callers; the anomaly auto-dump swallows it."""
        payload = self.get_gzip(capsule_id)
        if payload is None:
            return None
        directory = dump_dir or self.dump_dir
        if not directory:
            raise OSError("no flight_recorder_dump_dir configured")
        os.makedirs(directory, exist_ok=True)
        path = self._dump_path(capsule_id, directory)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        metrics.FLIGHTRECORDER_DUMPS.inc({"trigger": trigger})
        return path

    def flush_dumps(self) -> List[str]:
        """Dump every retained anomaly capsule not already on disk — the
        commit-time auto-dump can fail silently (full disk) or the dump dir
        may have been configured after the anomaly fired. The operator's
        shutdown path calls this BEFORE releasing its ports, so a SIGTERM
        never loses an anomaly capsule the post-mortem
        (``python -m karpenter_tpu_torch.replay``) would need. Returns the paths
        written; a still-unwritable disk yields an empty list, never an
        exception (shutdown must proceed)."""
        with self._lock:
            dump_dir = self.dump_dir
            pending = [
                c["id"] for c in self._ring
                if c.get("anomalies")
                and dump_dir
                and not os.path.exists(self._dump_path(c["id"], dump_dir))
            ]
        written: List[str] = []
        for capsule_id in pending:
            try:
                path = self.dump(capsule_id, trigger="flush")
            except OSError:
                continue
            if path:
                written.append(path)
        return written

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_id.clear()
            self._it_wire.clear()


#: process-wide default recorder (controllers and the debug HTTP surface
#: import this, like DECISIONS / TRACER / REGISTRY)
FLIGHT = FlightRecorder()
