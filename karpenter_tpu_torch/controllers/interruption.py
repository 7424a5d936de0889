"""Interruption + rebalance controller: queue events -> proactive capacity
moves, cordon & drain, and risk/ICE feedback.

Rebuild of the reference's SQS-driven interruption handling
(upstream ``pkg/controllers/interruption``): a singleton poll loop receives
messages (long-poll 20s / 10 msgs, ``sqs.go:86-97``), parses them through a registry
keyed on (version, source, detail-type) (``parser.go:31-93``), and maps actions
(``controller.go:261-268``):

* spot-interruption   -> CordonAndDrain + mark the spot offering unavailable
                          in the ICE cache (``controller.go:186-193``) + record
                          the realized reclaim in the interruption-risk cache
                          (exactly once per instance) + synchronously dirty the
                          drained pods into the provisioning controller so the
                          next delta round re-solves them (rounds-to-
                          replacement == 1, no watch-latency gap)
* rebalance-recommendation -> risk-cache bump; with spot management enabled,
                          PROACTIVE rebalance: launch replacement capacity
                          from the best risk-adjusted pool first, gate the
                          drain on the replacement going Ready, and fall back
                          to plain cordon-and-drain when the 2-minute notice
                          window expires first (KubePACS-style interruption-
                          driven rebalancing; event-only otherwise)
* scheduled-change (health) -> CordonAndDrain
* instance state-change (stopping/terminated) -> CordonAndDrain
* anything else -> noop

CordonAndDrain = delete the node and let the termination finalizer do the
cordon/drain/terminate work (``controller.go:201-212``). Rebalance rounds are
captured as flight-recorder capsules (queue messages + pending-rebalance
state ride the inputs), so ``python -m karpenter_tpu_torch.replay`` re-runs them
byte-identically offline — including ``--override risk.<it>/<zone>/<ct>=p``
counterfactuals against repriced pool risk.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import labels as wk
from ..state.cluster import Cluster
from ..utils import metrics
from ..utils.cache import Clock, UnavailableOfferings
from ..utils.events import Recorder
from .termination import TerminationController


# ---------------------------------------------------------------------------
# Queue (stands in for SQS; same receive/delete surface)
# ---------------------------------------------------------------------------

@dataclass
class QueueMessage:
    id: str
    body: str
    receive_count: int = 0


class FakeQueue:
    """In-memory interruption queue with the SQS receive/delete shape
    (reference SQSProvider, sqs.go:33-105)."""

    def __init__(self) -> None:
        # insertion-ordered dict: receive() takes the head, delete() is O(1)
        # (a 15k-message storm over a list was O(Q^2) in deletes alone)
        self._messages: Dict[str, QueueMessage] = {}
        self._lock = threading.Lock()
        self._counter = 0

    def send(self, body: Dict) -> str:
        with self._lock:
            self._counter += 1
            mid = f"msg-{self._counter}"
            self._messages[mid] = QueueMessage(id=mid, body=json.dumps(body))
            return mid

    def send_raw(self, body: str) -> str:
        """Enqueue a pre-serialized (possibly unparseable) body verbatim —
        the replay harness refeeds recorded message bodies through this so
        garbage messages replay as garbage."""
        with self._lock:
            self._counter += 1
            mid = f"msg-{self._counter}"
            self._messages[mid] = QueueMessage(id=mid, body=body)
            return mid

    def receive(self, max_messages: int = 10) -> List[QueueMessage]:
        with self._lock:
            batch = []
            for m in self._messages.values():
                if len(batch) >= max_messages:
                    break
                m.receive_count += 1
                batch.append(m)
            return batch

    def delete(self, message_id: str) -> None:
        with self._lock:
            self._messages.pop(message_id, None)

    def __len__(self) -> int:
        return len(self._messages)


# ---------------------------------------------------------------------------
# Messages + parser registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParsedMessage:
    kind: str  # spot-interruption | rebalance | scheduled-change | state-change | noop
    instance_ids: Tuple[str, ...] = ()
    detail: str = ""


Parser = Callable[[Dict], ParsedMessage]


class ParserRegistry:
    """Keyed on (version, source, detail-type) exactly like the reference's
    registry (parser.go:53-93); unknown shapes parse to noop."""

    def __init__(self) -> None:
        self._parsers: Dict[Tuple[str, str, str], Parser] = {}
        self._register_defaults()

    def register(self, version: str, source: str, detail_type: str, parser: Parser) -> None:
        self._parsers[(version, source, detail_type)] = parser

    def parse(self, raw: Dict) -> ParsedMessage:
        key = (
            str(raw.get("version", "0")),
            str(raw.get("source", "")),
            str(raw.get("detail-type", "")),
        )
        parser = self._parsers.get(key)
        if parser is None:
            return ParsedMessage(kind="noop")
        return parser(raw)

    def _register_defaults(self) -> None:
        def ids(raw: Dict) -> Tuple[str, ...]:
            detail = raw.get("detail", {})
            if "instance-id" in detail:
                return (detail["instance-id"],)
            return tuple(
                r.rsplit("/", 1)[-1] for r in raw.get("resources", []) if isinstance(r, str)
            )

        self.register(
            "0", "cloud.compute", "Spot Instance Interruption Warning",
            lambda raw: ParsedMessage(kind="spot-interruption", instance_ids=ids(raw)),
        )
        self.register(
            "0", "cloud.compute", "Instance Rebalance Recommendation",
            lambda raw: ParsedMessage(kind="rebalance", instance_ids=ids(raw)),
        )
        self.register(
            "0", "cloud.health", "Scheduled Change",
            lambda raw: ParsedMessage(kind="scheduled-change", instance_ids=ids(raw)),
        )
        self.register(
            "0", "cloud.compute", "Instance State-change Notification",
            lambda raw: ParsedMessage(
                kind="state-change",
                instance_ids=ids(raw),
                detail=str(raw.get("detail", {}).get("state", "")),
            ),
        )


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

ACTIONABLE_STATES = {"stopping", "stopped", "shutting-down", "terminated"}

#: the cloud's spot-reclaim notice window: a proactive rebalance that cannot
#: get its replacement Ready inside this falls back to plain cordon-and-drain
REBALANCE_NOTICE_S = 120.0

#: bound on the seen-reclaim dedupe set (exactly-once risk accounting); a
#: long-lived operator prunes the oldest half past this
_RECLAIMED_MAX = 8192


@dataclass
class PendingRebalance:
    """One node mid-rebalance: replacement launched, drain gated on it."""

    node: str
    pool: Tuple[str, str, str]
    replacement: str  # replacement node name
    deadline: float  # clock time for the cordon-and-drain fallback


class InterruptionController:
    def __init__(
        self,
        cluster: Cluster,
        queue: FakeQueue,
        termination: TerminationController,
        unavailable_offerings: Optional[UnavailableOfferings] = None,
        recorder: Optional[Recorder] = None,
        risk_cache=None,
        provisioning=None,
        provider=None,
        settings=None,
        clock: Optional[Clock] = None,
    ):
        self.cluster = cluster
        self.queue = queue
        self.termination = termination
        self.unavailable_offerings = unavailable_offerings or UnavailableOfferings()
        self.recorder = recorder or Recorder()
        # risk-aware spot pools: realized interruptions and rebalance hints
        # feed the per-pool probability estimates (utils/riskcache.py)
        self.risk_cache = risk_cache
        # interruption->provisioning fast path: drained pods dirty the delta
        # encoder + arm the batch window synchronously (note_interrupted)
        self.provisioning = provisioning
        # federation hook (operator wiring): realized risk events feed the
        # arbiter through the next capacity summary; None = single-cluster
        self.federation = None
        # cost-ledger hook (operator wiring): exactly-once reclaims charge
        # the restart tax; rebalance replacements report price regressions
        self.costs = None
        # cloud provider + settings enable the PROACTIVE rebalance path
        # (replacement launch needs a catalog and the risk penalty knob)
        self.provider = provider
        self.settings = settings
        self.clock = clock or Clock()
        # replay pin: launched replacement names must reproduce offline
        self.machine_ids = None
        # nodes mid-rebalance (replacement launched, drain gated)
        self._rebalances: Dict[str, PendingRebalance] = {}
        # instance ids whose reclaim was already accounted: exactly-once risk
        # recording and double-drain protection under duplicate messages
        self._reclaimed: Dict[str, None] = {}
        self._reclaimed_lock = threading.Lock()
        self.parsers = ParserRegistry()
        # instance-id -> node-name map, built lazily once and then maintained
        # INCREMENTALLY by node watch events. Mere invalidation is not enough:
        # a storm deletes nodes every batch, so an invalidated map would be
        # rebuilt O(nodes) per batch — O(N^2) across a 15k-node storm (this was
        # ~2/3 of the round-3 throughput sag at the top size). The generation
        # counter closes the build-vs-event race: a full build only publishes
        # if no node event landed while it ran; events patch a published map
        # in place under the lock.
        self._id_map: Optional[Dict[str, str]] = None
        self._id_gen = 0
        self._id_lock = threading.Lock()
        self._reb_lock = threading.Lock()
        self._round_actions: List[Dict] = []
        # per-round catalog snapshot: replacement-pool pricing is frozen at
        # round start (see reconcile), never read live mid-batch
        self._round_types: Optional[List[Tuple]] = None
        self._pool = None  # persistent worker pool (created on first batch)
        cluster.watch(self._on_event)

    def _on_event(self, event: str, obj) -> None:
        from ..api.objects import Node

        if isinstance(obj, Node):
            with self._id_lock:
                self._id_gen += 1
                if self._id_map is None or not obj.provider_id:
                    return
                iid = obj.provider_id.rsplit("/", 1)[-1]
                if event == "DELETED":
                    self._id_map.pop(iid, None)
                else:  # ADDED / MODIFIED — provider identity is stable per node
                    self._id_map[iid] = obj.name

    #: concurrent message workers, matching the reference's 10-way
    #: reconciler (controller.go:101 MaxConcurrentReconciles)
    WORKERS = 10

    def reconcile(self, max_messages: int = 10) -> int:
        """One poll cycle; returns the number of messages handled. Messages
        fan out over a worker pool — parsing and handling are independent per
        message; node deletion and the termination pass serialize internally
        (cluster lock / termination queue). Pending rebalances advance FIRST
        (a Ready replacement gates its original's drain open before new
        messages are judged), and rounds with rebalance activity are captured
        as flight-recorder capsules for byte-identical offline replay."""
        from ..utils.flightrecorder import FLIGHT

        messages = self.queue.receive(max_messages)
        if not messages and not self._rebalances:
            return 0
        now = self.clock.now()
        due = self._rebalances_due(now)
        if not messages and not due:
            # gated drains waiting on a replacement: nothing can progress
            # this tick — do NOT open a capsule (a slow replacement would
            # otherwise turn every idle poll into a full-snapshot capture,
            # flooding the bounded ring at the poll rate)
            return 0
        # a "rebalance round" — recommendation messages in the batch or a
        # pending rebalance that can actually advance — gets a capsule;
        # plain interruption storms stay capture-free (throughput path)
        rebalance_round = due or any("Rebalance" in m.body for m in messages)
        cap = None
        if rebalance_round and self.provider is not None:
            cap = FLIGHT.begin("rebalance")
            # ONE catalog snapshot for the whole round: every replacement
            # choice prices against it, so mid-batch risk/ICE writes (and
            # worker-thread ordering) cannot change a later message's pool
            # pick — the capsule records exactly this catalog, which is what
            # makes the offline replay byte-identical
            provs = sorted(
                self.cluster.provisioners.values(), key=lambda p: p.name
            )
            self._round_types = [
                (p, self.provider.get_instance_types(p)) for p in provs
            ]
        self._round_actions = []
        try:
            # quiesce capsule rounds (see provisioning.reconcile): remote
            # watch events between input capture and the round's cluster
            # reads would make the recorded action list irreproducible
            with (self.cluster.quiesce() if cap is not None
                  else contextlib.nullcontext()):
                if cap is not None:
                    self._capture_inputs(cap, messages)
                victims: List[str] = []
                acted_adv = self._advance_rebalances(victims)
                handled, acted_msgs = self._process(messages, victims)
                if acted_adv or acted_msgs:
                    # ONE drain pass for the whole batch (delete_node marks
                    # nodes; the termination finalizer serializes the work)
                    self.termination.reconcile()
                    self._notify_provisioning(victims)
                if cap is not None and cap.captured:
                    cap.set_outputs_rebalance(self._sorted_actions())
        except BaseException as e:
            if cap is not None:
                cap.finish(error=e)
            raise
        finally:
            self._round_types = None
        if cap is not None:
            cap.finish()
        return handled

    def _rebalances_due(self, now: float) -> bool:
        """True when any pending rebalance can make progress this tick: its
        node vanished, its replacement went Ready, or its deadline passed —
        the cheap pre-check that keeps idle gated-drain polls from becoming
        capsule-capturing rebalance rounds."""
        if not self._rebalances:
            return False
        with self._reb_lock:
            pending = list(self._rebalances.values())
        for ent in pending:
            node = self.cluster.nodes.get(ent.node)
            if node is None or node.meta.deletion_timestamp is not None:
                return True
            repl = self.cluster.nodes.get(ent.replacement)
            if repl is not None and repl.ready:
                return True
            if now >= ent.deadline:
                return True
        return False

    def _sorted_actions(self) -> List[Dict]:
        """The round's rebalance actions in canonical (node, action) order:
        message handling fans out over worker threads, so append order is
        scheduler-dependent — the capsule and the offline replay must both
        compare the same deterministic ordering."""
        return sorted(
            self._round_actions,
            key=lambda a: (a.get("node", ""), a.get("action", "")),
        )

    def _capture_inputs(self, cap, messages: List[QueueMessage]) -> None:
        """Rebalance-round capsule input: the cluster + catalog snapshot
        (risk probabilities ride the offerings exactly as the ICE mask rides
        ``available``), the batch's raw message bodies, and the pending-
        rebalance state — everything the offline replay refeeds."""
        now = self.clock.now()
        cap.capture_inputs(
            cluster=self.cluster,
            provisioner_types=list(self._round_types or ()),
            settings=self.settings,
            provider=self.provider,
            clock_now=now,
            extra={
                "queue_messages": [m.body for m in messages],
                "rebalance_pending": [
                    {
                        "node": r.node,
                        "pool": list(r.pool),
                        "replacement": r.replacement,
                        "deadline_remaining": r.deadline - now,
                    }
                    for _, r in sorted(self._rebalances.items())
                ],
            },
        )

    def _process(
        self, messages: List[QueueMessage], victims: List[str]
    ) -> Tuple[int, bool]:
        if not messages:
            return 0, False
        node_by_instance = self._instance_id_map()
        acted = []

        def one(msg) -> int:
            try:
                parsed = self.parsers.parse(json.loads(msg.body))
            except (json.JSONDecodeError, TypeError):
                metrics.INTERRUPTION_MESSAGES.inc({"kind": "unparseable"})
                self.queue.delete(msg.id)
                return 0
            if self._handle(parsed, node_by_instance, victims):
                acted.append(True)
            metrics.INTERRUPTION_MESSAGES.inc({"kind": parsed.kind})
            self.queue.delete(msg.id)
            return 1

        if len(messages) == 1:
            handled = one(messages[0])
        else:
            # persistent pool: spinning up + joining 10 threads per 100-message
            # batch cost ~8ms/batch — a visible slice of storm throughput
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.WORKERS,
                    thread_name_prefix="interruption-worker",
                )
            handled = sum(self._pool.map(one, messages))
        return handled, bool(acted)

    def _notify_provisioning(self, victim_names: List[str]) -> None:
        """Satellite of the drain path: the evicted (now Pending) pods are
        dirtied into the provisioning controller synchronously — the next
        delta round re-solves them without waiting for watch delivery."""
        if self.provisioning is None or not victim_names:
            return
        pods = [
            p for name in dict.fromkeys(victim_names)
            if (p := self.cluster.pods.get(name)) is not None
        ]
        if pods:
            self.provisioning.note_interrupted(pods)

    def close(self, wait: bool = False) -> None:
        """Release the worker pool (the operator calls this on shutdown; the
        watch ref pins this controller, so threads won't die with GC).
        ``wait=True`` joins in-flight workers first — the operator's ordered
        SIGTERM shutdown uses it so no drain mutates state mid-teardown;
        the retry policy's total deadline bounds how long that can take."""
        if self._pool is not None:
            self._pool.shutdown(wait=wait)
            self._pool = None

    def _instance_id_map(self) -> Dict[str, str]:
        """instance id -> node name, parsed from providerIDs
        (makeInstanceIDMap, controller.go:240-259); watch-maintained cache."""
        cached = self._id_map
        if cached is not None:
            return cached
        with self._id_lock:
            gen = self._id_gen
        out = {}
        for node in list(self.cluster.nodes.values()):
            if node.provider_id:
                out[node.provider_id.rsplit("/", 1)[-1]] = node.name
        with self._id_lock:
            if self._id_gen == gen:
                self._id_map = out  # no node event raced the build
        return out

    def _handle(
        self,
        parsed: ParsedMessage,
        node_by_instance: Dict[str, str],
        victims: List[str],
    ) -> bool:
        """Apply one parsed message; returns True when a node was marked for
        deletion (the caller runs one termination pass per batch). Drained
        nodes' non-daemonset pods append to ``victims`` for the synchronous
        provisioning notify."""
        if parsed.kind == "noop":
            return False
        if parsed.kind == "state-change" and parsed.detail not in ACTIONABLE_STATES:
            return False
        acted = False
        for instance_id in parsed.instance_ids:
            node_name = node_by_instance.get(instance_id)
            if node_name is None:
                continue
            node = self.cluster.nodes.get(node_name)
            if node is None:
                continue
            self.recorder.publish(
                parsed.kind, f"interruption event for {instance_id}",
                object_name=node_name, object_kind="Node", type="Warning",
            )
            pool = node.capacity_pool()
            if parsed.kind == "rebalance":
                # event only in the reference (controller.go:264); here a
                # risk signal, and — with spot management on — the trigger
                # for a proactive replace-then-drain
                if node_name in self._rebalances:
                    continue  # recommendation repeat: already mid-rebalance
                self._note_risk("rebalance", pool)
                if self._proactive_enabled():
                    if self._begin_rebalance(node, pool, victims):
                        acted = True
                continue
            if parsed.kind == "spot-interruption":
                # capacity signal: this spot pool is about to be reclaimed; treat
                # as unavailable for the ICE window (controller.go:186-193)
                if self._note_reclaim(instance_id):
                    self._note_risk(
                        "interruption", (pool[0], pool[1], wk.CAPACITY_TYPE_SPOT)
                    )
                    if self.costs is not None:
                        # same exactly-once edge as the risk note: the ledger
                        # charges one restart tax per reclaimed instance
                        self.costs.note_reclaim(
                            (pool[0], pool[1], wk.CAPACITY_TYPE_SPOT)
                        )
                elif node.meta.deletion_timestamp is not None:
                    continue  # duplicate message: node already draining
                self.unavailable_offerings.mark_unavailable(
                    node.instance_type(), node.zone(), wk.CAPACITY_TYPE_SPOT,
                    reason="spot-interruption",
                )
                # the reclaim won any race with a pending proactive rebalance
                with self._reb_lock:
                    self._rebalances.pop(node_name, None)
            self._drain_node(node_name, victims)
            acted = True
        return acted

    # -- risk accounting ----------------------------------------------------
    def _note_risk(self, kind: str, pool: Tuple[str, str, str]) -> None:
        if self.risk_cache is None:
            return
        if kind == "interruption":
            self.risk_cache.record_interruption(*pool)
        else:
            self.risk_cache.record_rebalance(*pool)
        metrics.RISK_OBSERVATIONS.inc({"kind": kind})
        if self.federation is not None:
            # advisory feed: realized reclaims/rebalances reach the arbiter
            # through the NEXT capacity summary (shared risk cache); the
            # hook keeps the coupling explicit for the federation tests
            self.federation.note_regional_risk(kind, pool)

    def _note_reclaim(self, instance_id: str) -> bool:
        """Exactly-once reclaim accounting: True only for the FIRST message
        naming this instance — duplicates (re-deliveries, fan-out copies)
        must not double-count risk evidence or re-drain."""
        with self._reclaimed_lock:
            if instance_id in self._reclaimed:
                return False
            self._reclaimed[instance_id] = None
            if len(self._reclaimed) > _RECLAIMED_MAX:
                # dict preserves insertion order: drop the oldest half
                for key in list(self._reclaimed)[: _RECLAIMED_MAX // 2]:
                    del self._reclaimed[key]
            return True

    def _proactive_enabled(self) -> bool:
        return (
            self.provider is not None
            and self.settings is not None
            and getattr(self.settings, "spot_enabled", False)
        )

    def _drain_node(self, name: str, victims: List[str]) -> None:
        """Cordon-and-drain one node, collecting its non-daemonset pods for
        the synchronous provisioning notify — the single drain entry point
        for message handling, proactive fallbacks and gated-drain advances."""
        victims.extend(
            p.name for p in self.cluster.pods_on_node(name)
            if not p.is_daemonset
        )
        self.termination.delete_node(name)

    # -- proactive rebalance (replacement-before-drain) ---------------------
    def _begin_rebalance(self, node, pool, victims: List[str]) -> bool:
        """Open replacement capacity for ``node`` from the best risk-adjusted
        alternative pool, then gate the drain on the replacement going Ready
        (_advance_rebalances), with the notice-window deadline as the plain
        cordon-and-drain fallback. Returns True when the node was drained
        IMMEDIATELY (no alternative pool / launch failure)."""
        from ..utils.decisions import DECISIONS

        name = node.name
        with self._reb_lock:
            if name in self._rebalances or node.meta.deletion_timestamp is not None:
                return False
            # reserve before launching: a duplicate recommendation on a
            # parallel worker must not open a second replacement while this
            # one's launch RPC is in flight — and the RPC itself must run
            # OUTSIDE the lock, or one slow cloud call serializes the whole
            # worker pool behind it
            self._rebalances[name] = PendingRebalance(
                node=name, pool=pool, replacement="",
                deadline=self.clock.now() + REBALANCE_NOTICE_S,
            )
        spec = self._replacement_spec(node, pool)
        if spec is None:
            # nowhere better to go: the recommendation degrades to the
            # reference's behavior plus an honest drain
            with self._reb_lock:
                self._rebalances.pop(name, None)
            self._record_action("immediate-drain", name, pool, None)
            DECISIONS.record(
                "rebalance", "immediate-drain", node=name,
                reason="no alternative capacity pool for replacement",
                details={"pool": "/".join(pool)},
            )
            self._drain_node(name, victims)
            return True
        from .provisioning import launch_from_spec

        try:
            _, new_node = launch_from_spec(
                self.cluster, self.provider, spec,
                requests=self._node_requests(name),
                machine_ids=self.machine_ids,
            )
        except Exception as e:  # noqa: BLE001 — any launch failure
            with self._reb_lock:
                self._rebalances.pop(name, None)
            self._record_action("immediate-drain", name, pool, spec)
            DECISIONS.record(
                "rebalance", "immediate-drain", node=name,
                reason=f"replacement launch failed: {e}",
                details={"pool": "/".join(pool)},
            )
            self._drain_node(name, victims)
            return True
        with self._reb_lock:
            ent = self._rebalances.get(name)
            if ent is not None:
                self._rebalances[name] = PendingRebalance(
                    node=name, pool=pool, replacement=new_node.name,
                    deadline=ent.deadline,
                )
            # else: a reclaim raced the launch and popped the reservation —
            # the node is draining; the fresh replacement stays and absorbs
            # the drained pods next provisioning round (capacity, not a leak)
        if self.costs is not None:
            # a replacement priced above the reclaimed pool is a realized
            # interruption loss (the re-launch delta stream); a cheaper or
            # unknown-price pool reports nothing
            pricing = getattr(self.provider, "pricing", None)
            old_price = pricing.price(*pool) if pricing is not None else None
            if old_price is not None:
                self.costs.note_relaunch(old_price, spec.option.price)
        self._record_action("replacement-launched", name, pool, spec, new_node.name)
        DECISIONS.record(
            "rebalance", "replacement-launched", node=name,
            reason="rebalance recommendation: replacement opened before drain",
            details={
                "pool": "/".join(pool),
                "replacement": new_node.name,
                "replacement_pool": "/".join(spec.option.pool),
                "price": round(spec.option.price, 5),
                "interruption_probability": round(
                    spec.option.interruption_probability, 4
                ),
            },
        )
        return False

    def _node_requests(self, node_name: str):
        from ..api.resources import Resources, merge

        pods = [
            p for p in self.cluster.pods_on_node(node_name)
            if not p.is_daemonset
        ]
        return merge([p.requests for p in pods]) + Resources(pods=len(pods))

    def _replacement_spec(self, node, pool):
        """The replacement NewNodeSpec: cheapest RISK-ADJUSTED available
        offering (price + p_interrupt * penalty) outside the threatened
        pool, restricted to types whose allocatable fits the node's current
        non-daemonset pod load. None when no such pool exists."""
        from ..api.requirements import Requirement, Requirements
        from ..solver.encode import LaunchOption
        from ..solver.result import NewNodeSpec

        prov = self.cluster.provisioners.get(node.provisioner_name() or "")
        if prov is None:
            return None
        requests = self._node_requests(node.name)
        penalty = getattr(self.settings, "interruption_penalty_cost", 0.0)
        # price against the round-start catalog snapshot: a parallel worker's
        # _note_risk bumps risk.version mid-batch, and a live get_instance_types
        # here would re-stamp probabilities — making a later message's pool
        # pick thread-scheduling-dependent and diverging from the capsule's
        # recorded catalog on replay (direct unit-test calls, with no round
        # open, fall back to the live read)
        types = None
        if self._round_types is not None:
            for p, ts in self._round_types:
                if p.name == prov.name:
                    types = ts
                    break
        if types is None:
            types = self.provider.get_instance_types(prov)
        best = None  # (eff_price, it_name, zone, ct, it, offering)
        for it in types:
            alloc = it.allocatable()
            if not requests.fits(alloc):
                continue
            for o in it.offerings:
                if not o.available:
                    continue
                if (it.name, o.zone, o.capacity_type) == pool:
                    continue
                eff = o.price + o.interruption_probability * penalty
                cand = (eff, it.name, o.zone, o.capacity_type)
                if best is None or cand < best[:4]:
                    best = (eff, it.name, o.zone, o.capacity_type, it, o)
        if best is None:
            return None
        _, _, zone, ct, it, o = best
        option = LaunchOption(
            provisioner=prov,
            instance_type=it,
            zone=zone,
            capacity_type=ct,
            price=o.price,
            node_requirements=it.requirements.intersect(
                Requirements([
                    Requirement.in_values(wk.ZONE, [zone]),
                    Requirement.in_values(wk.CAPACITY_TYPE, [ct]),
                ])
            ),
            taints=tuple(prov.taints),
            allocatable=it.allocatable(),
            interruption_probability=o.interruption_probability,
            risk_cost=o.interruption_probability * penalty,
        )
        return NewNodeSpec(option=option, pod_names=[])

    def _advance_rebalances(self, victims: List[str]) -> bool:
        """Advance every pending rebalance: drain the original once its
        replacement is Ready; past the notice-window deadline fall back to
        plain cordon-and-drain. Returns True when any node was drained."""
        if not self._rebalances:
            return False
        from ..utils.decisions import DECISIONS

        acted = False
        now = self.clock.now()
        with self._reb_lock:
            pending = sorted(self._rebalances.items())
        for name, ent in pending:
            node = self.cluster.nodes.get(name)
            if node is None or node.meta.deletion_timestamp is not None:
                # reclaimed/deleted out from under the rebalance
                with self._reb_lock:
                    self._rebalances.pop(name, None)
                continue
            repl = self.cluster.nodes.get(ent.replacement)
            if repl is not None and repl.ready:
                action = "drained-after-replacement"
                reason = f"replacement {ent.replacement} Ready"
            elif now >= ent.deadline:
                action = "deadline-drain"
                reason = (
                    f"replacement {ent.replacement} not Ready inside the "
                    f"{REBALANCE_NOTICE_S:.0f}s notice window"
                )
            else:
                continue
            self._drain_node(name, victims)
            with self._reb_lock:
                self._rebalances.pop(name, None)
            self._record_action(action, name, ent.pool, None, ent.replacement)
            DECISIONS.record(
                "rebalance", action, node=name, reason=reason,
                details={
                    "pool": "/".join(ent.pool),
                    "replacement": ent.replacement,
                },
            )
            acted = True
        return acted

    def _record_action(
        self, action: str, node: str, pool, spec=None, replacement: str = ""
    ) -> None:
        metrics.REBALANCE_ACTIONS.inc({"action": action})
        entry: Dict = {
            "action": action,
            "node": node,
            "pool": list(pool),
        }
        if spec is not None:
            entry["replacement_pool"] = list(spec.option.pool)
        if replacement:
            entry["replacement"] = replacement
        self._round_actions.append(entry)
