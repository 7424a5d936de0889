"""Offline deterministic replay of flight-recorder capsules.

    python -m karpenter_tpu_torch.replay capsule-provisioning.17.json.gz
    python -m karpenter_tpu_torch.replay <capsule> --device cpu
    python -m karpenter_tpu_torch.replay <capsule> --explain pod=web-3
    python -m karpenter_tpu_torch.replay <capsule> --override settings.batch_max_duration=0 \
        --override 'offerings=m5.large/us-east-1a/spot=unavailable'
    python -m karpenter_tpu_torch.replay <capsule> --override provisioner.default.limits.cpu=500

A copy of ``karpenter_tpu/replay.py``, replaying through the port's
``TorchSolver``. It differs from the reference in three ways, each also
listed in ``ROADMAP.md``'s deliberate differences:

* ``_make_solver`` maps the solver names of both packages' capsules
  (``TPUSolver``/``tpu``, ``TorchSolver``/``torch``) to
  ``TorchSolver(device=device)``, and ``tpu-quality``/``torch-quality`` to
  ``TorchSolver(latency_budget_s=30.0, device=device)``;
* ``replay_capsule(..., device=...)`` and ``--device`` default to ``cuda``,
  as the operator's entry point does. There is no fallback: without CUDA
  and without ``--device cpu`` the ``TorchSolver`` constructor raises. A
  federation capsule's sub-capsules replay through the same solver name
  and device (``_replay_federation``);
* a sharded round replays on per-cell clones of the replay's solver, each
  behind a digest tap, one cell at a time (``_replay_provisioning``); the
  reference's cells share its one tapped solver.

Reconstructs the cluster exactly as the recorded reconcile saw it (objects at
their captured resourceVersions, pods in the encode-canonical order, the
instance-type/offering lists with the ICE mask baked in, the recorded
settings), re-runs provisioning or consolidation through the **real solver
with no network** — replay denies socket connects outright, the whole round
runs against in-process state — and diffs the replayed problem digests,
placements, and decision verdicts against the recorded ones. The session's
delta-vs-full equivalence contract is what makes this sound: a round's
(possibly delta) encode is digest-identical to a from-scratch encode of its
canonical inputs, so byte-equal digests mean the replay solved the *same
problem*, not a similar one.

``--override`` turns the replay into a counterfactual ("would this pod have
scheduled with a higher limit / without that ICE mask?"): the report then
describes what WOULD have happened instead of asserting equality.

Exit codes: 0 — replay matches the record (or ran as a counterfactual);
2 — the replay diverged from the record; 1 — bad capsule / usage.
"""

from __future__ import annotations

import argparse
import gzip
import itertools
import json
import socket
import sys
import threading
from dataclasses import fields
from typing import Dict, List, Optional, Sequence, Tuple

_replay_seq = itertools.count(1)


# ---------------------------------------------------------------------------
# Capsule IO + overrides
# ---------------------------------------------------------------------------

def load_capsule(path: str) -> Dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


class OverrideError(ValueError):
    pass


def _coerce_like(current, raw: str):
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise OverrideError(f"invalid boolean {raw!r}")
    try:
        if isinstance(current, float):
            return float(raw)
        if isinstance(current, int):
            return int(raw)
    except ValueError as e:
        raise OverrideError(str(e)) from None
    return raw


def apply_overrides(capsule: Dict, overrides: Sequence[str]) -> Dict:
    """Apply ``--override`` directives to a (deep-copied) capsule:

    * ``settings.<field>=<value>`` — replay under different settings
      (topology counterfactuals ride this:
      ``settings.slice_topology_enabled=false`` replays a recorded round
      topology-blind, ``settings.slice_hop_penalty_frac=<f>`` re-prices
      adjacency — the capsule catalog already carries the ICI coordinates);
    * ``offerings=<type>/<zone>/<ct>=available|unavailable|price:<x>`` —
      flip an offering's availability (undo an ICE mask, simulate one) or
      reprice it; ``*`` wildcards any path segment;
    * ``risk.<type>/<zone>/<ct>=<p>`` — repin a capacity pool's recorded
      interruption probability ("what if this pool were riskier"): the
      risk-priced solve and the rebalance controller's replacement choice
      both see the counterfactual estimate; ``*`` wildcards segments;
    * ``provisioner.<name>.limits.<resource>=<quantity>`` — raise/lower a
      provisioner's resource ceiling (``none`` removes all limits);
    * ``provisioner.<name>.weight=<int>`` — re-rank the pool cascade.
    """
    import copy

    capsule = copy.deepcopy(capsule)
    inputs = capsule.setdefault("inputs", {})
    for directive in overrides:
        if "=" not in directive:
            raise OverrideError(f"override {directive!r} is not key=value")
        key, _, value = directive.partition("=")
        if key.startswith("settings."):
            field = key[len("settings."):]
            settings = inputs.setdefault("settings", {})
            if field not in settings:
                raise OverrideError(f"unknown settings field {field!r}")
            settings[field] = _coerce_like(settings[field], value)
        elif key == "offerings":
            _apply_offering_override(inputs, value)
        elif key.startswith("risk."):
            _apply_risk_override(inputs, key[len("risk."):], value)
        elif key.startswith("provisioner."):
            _apply_provisioner_override(inputs, key[len("provisioner."):], value)
        elif key.startswith("cluster."):
            _apply_cluster_override(inputs, key[len("cluster."):], value)
        else:
            raise OverrideError(
                f"unknown override {key!r} (use settings.*, offerings=..., "
                "risk.<type>/<zone>/<ct>=<p>, provisioner.<name>.*, "
                "cluster.<name>.available=<bool>, cluster.<name>.risk.*=<p>)"
            )
    return capsule


def _apply_cluster_override(inputs: Dict, sel: str, value: str) -> None:
    """Federation counterfactuals: ``cluster.<name>.available=false`` drops
    a member from the round ("where would this gang have landed if region A
    were dead"), ``cluster.<name>.risk.<pool-or-*>=<p>`` repins a member
    summary's pool risk (and recomputes its risk_peak) — the federation
    analogue of the pool risk overrides."""
    if "available" not in inputs and "summaries" not in inputs:
        raise OverrideError(
            "cluster.* overrides apply to federation capsules only"
        )
    name, _, rest = sel.partition(".")
    if not name or not rest:
        raise OverrideError(
            f"cluster override {sel!r} is not "
            "cluster.<name>.available=<bool> or cluster.<name>.risk.<sel>=<p>"
        )
    known = set(inputs.get("available", {})) | set(inputs.get("summaries", {}))
    if name not in known:
        raise OverrideError(
            f"unknown cluster {name!r} (capsule members: {sorted(known)})"
        )
    if rest == "available":
        inputs.setdefault("available", {})[name] = _coerce_like(True, value)
        return
    if rest == "risk" or rest.startswith("risk."):
        pool_sel = rest[len("risk."):] if rest.startswith("risk.") else "*"
        try:
            p = float(value)
        except ValueError as e:
            raise OverrideError(str(e)) from None
        if not 0.0 <= p <= 1.0:
            raise OverrideError(f"risk probability {p} not in [0, 1]")
        summary = inputs.get("summaries", {}).get(name)
        if summary is None:
            raise OverrideError(
                f"cluster {name!r} has no summary in this capsule"
            )
        risk = summary.setdefault("risk", {})
        if pool_sel in ("*", ""):
            for key in risk:
                risk[key] = p
            summary["risk_peak"] = p
        else:
            risk[pool_sel] = p  # pins pools the summary never saw, too
            summary["risk_peak"] = max(risk.values()) if risk else 0.0
        return
    raise OverrideError(
        f"unknown cluster override field {rest!r} (use available or risk.*)"
    )


def _apply_risk_override(inputs: Dict, sel: str, value: str) -> None:
    parts = sel.split("/")
    if len(parts) != 3:
        raise OverrideError(
            f"risk override {sel!r} is not risk.<type>/<zone>/<ct>=<p>"
        )
    it_name, zone, ct = parts
    try:
        p = float(value)
    except ValueError as e:
        raise OverrideError(str(e)) from None
    if not 0.0 <= p <= 1.0:
        raise OverrideError(f"risk probability {p} not in [0, 1]")
    hit = 0
    for types in inputs.get("instance_types", {}).values():
        for it in types:
            if it_name not in ("*", it["name"]):
                continue
            for o in it.get("offerings", []):
                if zone not in ("*", o["zone"]):
                    continue
                if ct not in ("*", o["capacityType"]):
                    continue
                o["interruptionProbability"] = p
                hit += 1
    if hit == 0:
        raise OverrideError(f"risk override {sel!r} matched nothing")


def _apply_offering_override(inputs: Dict, spec: str) -> None:
    sel, _, action = spec.rpartition("=")
    parts = sel.split("/")
    if len(parts) != 3 or not action:
        raise OverrideError(
            f"offerings override {spec!r} is not <type>/<zone>/<ct>=<action>"
        )
    it_name, zone, ct = parts
    hit = 0
    for types in inputs.get("instance_types", {}).values():
        for it in types:
            if it_name not in ("*", it["name"]):
                continue
            for o in it.get("offerings", []):
                if zone not in ("*", o["zone"]):
                    continue
                if ct not in ("*", o["capacityType"]):
                    continue
                hit += 1
                if action == "available":
                    o["available"] = True
                elif action == "unavailable":
                    o["available"] = False
                elif action.startswith("price:"):
                    try:
                        o["price"] = float(action[len("price:"):])
                    except ValueError as e:
                        raise OverrideError(str(e)) from None
                else:
                    raise OverrideError(f"unknown offering action {action!r}")
    if hit == 0:
        raise OverrideError(f"offerings override {spec!r} matched nothing")


def _apply_provisioner_override(inputs: Dict, path: str, value: str) -> None:
    from .api.resources import parse_quantity

    parts = path.split(".")
    name = parts[0]
    target = None
    for wire in inputs.get("objects", {}).get("provisioners", []):
        if wire["meta"]["name"] == name:
            target = wire
            break
    if target is None:
        raise OverrideError(f"no provisioner {name!r} in the capsule")
    if len(parts) == 3 and parts[1] == "limits":
        if value.lower() == "none":
            # remove ONLY the named resource's ceiling; the others stand
            limits = dict(target.get("limits") or {})
            limits.pop(parts[2], None)
            target["limits"] = limits or None
        else:
            limits = dict(target.get("limits") or {})
            try:
                limits[parts[2]] = float(parse_quantity(value))
            except (ValueError, TypeError) as e:
                raise OverrideError(str(e)) from None
            target["limits"] = limits
    elif len(parts) == 2 and parts[1] == "limits" and value.lower() == "none":
        target["limits"] = None
    elif len(parts) == 2 and parts[1] == "weight":
        try:
            target["weight"] = int(value)
        except ValueError as e:
            raise OverrideError(str(e)) from None
    else:
        raise OverrideError(
            f"unsupported provisioner override {path!r} "
            "(limits.<resource>=<qty>|none, weight=<int>)"
        )


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def settings_from_wire(d: Dict):
    from .api.settings import Settings

    known = {f.name for f in fields(Settings)}
    s = Settings(**{k: v for k, v in (d or {}).items() if k in known})
    s.validate()
    return s


def build_cluster(capsule: Dict):
    """In-process cluster, byte-faithful to the capsule: every kind in its
    captured order, except the batch pods, which append LAST in the recorded
    encode-canonical order — ``pending_pods()`` then yields exactly the
    sequence the session encoded, so the replay's from-scratch full encode
    is digest-identical to the recorded round's."""
    from .api import codec
    from .state.cluster import Cluster

    objs = capsule.get("inputs", {}).get("objects", {})
    cluster = Cluster()
    adders = {
        "nodetemplates": cluster.add_node_template,
        "provisioners": cluster.add_provisioner,
        "poddisruptionbudgets": cluster.add_pdb,
        "nodes": cluster.add_node,
        "machines": cluster.add_machine,
    }
    for kind, add in adders.items():
        for wire in objs.get(kind, []):
            add(codec.from_wire(kind, wire))
    batch_order = capsule.get("inputs", {}).get("batch_order") or []
    batch = set(batch_order)
    pod_wires = {w["meta"]["name"]: w for w in objs.get("pods", [])}
    for name, wire in pod_wires.items():
        if name not in batch:
            cluster.add_pod(codec.from_wire("pods", wire))
    for name in batch_order:
        wire = pod_wires.get(name)
        if wire is not None:
            cluster.add_pod(codec.from_wire("pods", wire))
    return cluster


class CapsuleCloudProvider:
    """A CloudProvider serving exactly the capsule's instance-type lists —
    the capture-time ICE mask included as offering availability — and
    launching machines in-process (FakeCloudProvider mechanics, zero
    network).

    Mid-round ICE churn replays too: the offerings whose launches failed
    with insufficient capacity in the RECORDED round (``nomination`` /
    ``ice-failed`` decisions) are pre-seeded into the fake's ICE pools, so
    the same launch fails, the same in-round re-solve runs, and the
    refreshed round-N catalog is the recorded round-0 catalog plus exactly
    those masks — the same delta the live provider served.

    TRANSIENT launch failures replay too (the chaos soak's RPC fault bursts
    flushed this out): a recorded round whose launches died on exhausted
    retries left its pods unschedulable, and a replay that launches them
    happily is a false DIVERGED. Machine names are minted once per spec
    (``launch_from_spec``) and the capsule pins the machine sequence, so the
    recorded ``new_nodes`` name set identifies exactly which creates
    committed — when the recorded round carried a ``launch-failed``
    nomination, any create whose machine name is NOT in that set raises
    ``TransientCloudError`` (unless its pinned pool is ICE-masked, which
    must keep raising ICE so the re-solve cascade replays unchanged)."""

    def __new__(cls, capsule: Dict):
        from .api import labels as wk
        from .cloudprovider.fake import FakeCloudProvider
        from .cloudprovider.interface import TransientCloudError
        from .cloudprovider.types import instance_type_from_wire

        per_prov: Dict[str, list] = {}
        union: Dict[str, object] = {}
        for pname, wires in capsule.get("inputs", {}).get("instance_types", {}).items():
            types = [instance_type_from_wire(w) for w in wires]
            per_prov[pname] = types
            for it in types:
                union.setdefault(it.name, it)
        outputs = capsule.get("outputs", {})
        committed_names = {
            n.get("name") for n in (outputs.get("new_nodes") or [])
            if n.get("name")
        }
        had_launch_failures = capsule.get("controller") == "provisioning" and any(
            d.get("kind") == "nomination" and d.get("outcome") == "launch-failed"
            for d in outputs.get("decisions", [])
        )

        def _pinned(machine, key):
            values = sorted(getattr(machine.requirements.get(key), "values", []) or [])
            return values[0] if len(values) == 1 else None

        class _Provider(FakeCloudProvider):
            def create(self, machine):
                if had_launch_failures and machine.meta.name not in committed_names:
                    # a create the recorded round did NOT commit: reproduce
                    # its transient failure — unless the pinned pool is
                    # ICE-masked, where super() must keep raising
                    # InsufficientCapacityError (the re-solve cascade path)
                    it = _pinned(machine, wk.INSTANCE_TYPE)
                    zone = _pinned(machine, wk.ZONE)
                    ct = _pinned(machine, wk.CAPACITY_TYPE)
                    masked = (
                        it is not None and zone is not None
                        and self.unavailable_offerings.is_unavailable(it, zone, ct or "")
                    )
                    if not masked:
                        raise TransientCloudError(
                            "recorded launch failure (replayed: this machine "
                            "name is absent from the capsule's new_nodes)"
                        )
                return super().create(machine)
            def get_instance_types(self, provisioner=None):
                key = provisioner.name if provisioner is not None else None
                base = per_prov.get(key) if key is not None else list(union.values())
                if base is None:
                    return super().get_instance_types(provisioner)
                seq = self.unavailable_offerings.seqnum
                if seq == 0:
                    return base  # round 0: the recorded lists, verbatim
                cached = self._replay_it_cache.get(key)
                if cached is not None and cached[0] == seq:
                    return cached[1]
                # in-round ICE marks re-mask the recorded catalog exactly as
                # the live provider's seqnum-keyed cache did (replace(), so
                # the recorded interruption probability rides along)
                from dataclasses import replace as _replace

                out = [
                    it.with_offerings([
                        _replace(
                            o,
                            available=o.available
                            and not self.unavailable_offerings.is_unavailable(
                                it.name, o.zone, o.capacity_type
                            ),
                        )
                        for o in it.offerings
                    ])
                    for it in base
                ]
                self._replay_it_cache[key] = (seq, out)
                return out

        provider = _Provider(catalog=list(union.values()))
        provider._replay_it_cache = {}
        for d in capsule.get("outputs", {}).get("decisions", []):
            if d.get("kind") == "nomination" and d.get("outcome") == "ice-failed":
                det = d.get("details", {})
                if det.get("instance_type") and det.get("zone"):
                    provider.set_insufficient_capacity(
                        det["instance_type"], det["zone"],
                        det.get("capacity_type", ""),
                    )
        return provider


class _DigestTapSolver:
    """Solver proxy collecting the per-round problem digests the recorded
    controller captured, so the two sequences compare 1:1."""

    def __init__(self, inner):
        self._inner = inner
        self.digests: List[str] = []

    def solve_pods(self, *args, **kwargs):
        result = self._inner.solve_pods(*args, **kwargs)
        self.digests.append(result.problem_digest)
        return result

    def solve(self, problem):
        return self._inner.solve(problem)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        # forward attribute WRITES to the wrapped solver too: the replayed
        # controller configures its solver by assignment (risk_penalty from
        # spot_enabled settings) and the inner solve path reads the value
        # off the REAL solver — a set stranded on the proxy would replay a
        # risk-priced round risk-neutral and falsely diverge
        if name in ("_inner", "digests"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)


def _make_solver(capsule: Dict, name: Optional[str] = None, device: str = "cuda"):
    """The replay's solver, by the capsule's recorded name or ``name``.

    Differs from the reference: the names of both packages' solvers map to
    the port's ``TorchSolver`` on ``device`` (the reference's capsules name
    ``TPUSolver``, the port's ``TorchSolver``), and an unknown name takes
    the default ``TorchSolver``, as the reference's takes ``TPUSolver``."""
    from .solver.solver import GreedySolver, TorchSolver

    name = name or capsule.get("solver", "TorchSolver")

    def torch_solver():
        return TorchSolver(device=device)

    by_name = {
        "TPUSolver": torch_solver, "tpu": torch_solver,
        "TorchSolver": torch_solver, "torch": torch_solver,
        "GreedySolver": GreedySolver, "greedy": GreedySolver,
        # quality-budget race (no deadline, cheaper validated answer wins):
        # deterministic across replays whatever the card's timing — the
        # mode that reproduces kernel-backend rounds offline
        "tpu-quality": lambda: TorchSolver(latency_budget_s=30.0, device=device),
        "torch-quality": lambda: TorchSolver(latency_budget_s=30.0, device=device),
    }
    return by_name.get(name, torch_solver)()


class _NoNetwork:
    """Replay runs fully offline: any socket connect ON THE REPLAY THREAD is
    a bug, denied loudly. (The reconstruction path never imports the HTTP
    clients, but a guard beats a convention.)

    The deny is per-thread, not process-wide: replaying inside a live
    operator must not break the watch thread's reconnects or any concurrent
    reconcile's HTTP calls. The connect stub is installed once (refcounted
    under a lock, so concurrent replays cannot race the save/restore) and
    passes every non-guarded thread straight through."""

    _lock = threading.Lock()
    _guarded: set = set()
    _orig = None

    def __enter__(self):
        cls = _NoNetwork
        with cls._lock:
            if not cls._guarded:
                cls._orig = orig = socket.socket.connect

                # orig is a CLOSURE local, not read off the class at call
                # time: an in-flight stub call on another thread must keep
                # working even while __exit__ restores the real connect
                def connect(sock, *a, **k):
                    if threading.get_ident() in cls._guarded:
                        raise RuntimeError(
                            "network call during offline replay — capsules "
                            "must replay with zero network I/O"
                        )
                    return orig(sock, *a, **k)

                socket.socket.connect = connect
            cls._guarded.add(threading.get_ident())
        return self

    def __exit__(self, *exc):
        cls = _NoNetwork
        with cls._lock:
            cls._guarded.discard(threading.get_ident())
            if not cls._guarded and cls._orig is not None:
                socket.socket.connect = cls._orig
        return False


# ---------------------------------------------------------------------------
# Replay + diff
# ---------------------------------------------------------------------------

def _decision_keys(decisions: List[Dict]) -> List[Tuple]:
    """Replay-comparable decision identity: kind/outcome/pod (+reason for
    unschedulable verdicts). Node and machine names are process-local."""
    out = []
    for d in decisions:
        key = [d.get("kind", ""), d.get("outcome", ""), d.get("pod", "")]
        if d.get("outcome") == "unschedulable":
            key.append(d.get("reason", ""))
        out.append(tuple(key))
    return sorted(out)


def _validation_keys(events) -> List[Tuple]:
    """Replay-comparable identity of a firewall evaluation: verdict,
    fallback decision, and the violation list — NOT the backend that
    produced the judged plan (cache state moves race winners between
    processes; the firewall's decisions must still reproduce)."""
    out = []
    for e in events or []:
        out.append((
            e.get("verdict", ""),
            e.get("fallback", ""),
            json.dumps(e.get("violations", []), sort_keys=True),
        ))
    return out


def _placement_key(entry: Dict) -> Tuple:
    if entry.get("existing"):
        return ("existing", entry.get("node", ""))
    return (
        "new",
        entry.get("instance_type", ""),
        entry.get("zone", ""),
        entry.get("capacity_type", ""),
    )


def replay_capsule(
    capsule: Dict,
    overrides: Sequence[str] = (),
    forbid_network: bool = True,
    solver: Optional[str] = None,
    device: str = "cuda",
) -> Dict:
    """Re-run the capsule's reconcile offline and diff against the record.
    Returns the report dict (see module docstring for the CLI rendering).
    ``device`` places the replay's ``TorchSolver`` (module docstring)."""
    from .utils import flightrecorder
    from .utils.decisions import DecisionLog, redirect_decisions, tee_decisions
    from .utils.logging import log_context

    counterfactual = bool(overrides)
    if overrides:
        capsule = apply_overrides(capsule, overrides)
    controller_kind = capsule.get("controller", "provisioning")
    if controller_kind == "federation":
        # federation capsules carry no cluster/provider inputs of their own
        # — the arbiter's verdict is a pure function of its recorded inputs,
        # and the per-cluster rounds live in embedded sub-capsules
        return _replay_federation(
            capsule, counterfactual, forbid_network=forbid_network,
            solver=solver, device=device,
        )
    settings = settings_from_wire(capsule.get("inputs", {}).get("settings", {}))
    rid = f"replay.{next(_replay_seq)}"
    from contextlib import nullcontext

    guard = _NoNetwork() if forbid_network else nullcontext()
    # capture isolation: the replayed controllers must not record capsules OF
    # the replay, and their DECISIONS writes land in a replay-private ring —
    # a live operator's audit log sees no phantom "replay.N" verdicts, and
    # concurrently-admitted live records cannot leak into this report.
    # (Process-local metrics ARE still touched by a replayed round; run the
    # CLI out-of-process when pristine gauges matter.)
    replay_log = DecisionLog()
    from .utils import lifecycle as _lifecycle

    with guard, flightrecorder.suppressed(), _lifecycle.suppressed(), \
            redirect_decisions(replay_log), \
            tee_decisions() as decision_tee, log_context(reconcile_id=rid):
        cluster = build_cluster(capsule)
        provider = CapsuleCloudProvider(capsule)
        base_solver = _make_solver(capsule, solver, device)
        tap = _DigestTapSolver(base_solver)
        if controller_kind == "provisioning":
            replayed = _replay_provisioning(capsule, cluster, provider, tap, settings)
        elif controller_kind == "rebalance":
            replayed = _replay_rebalance(
                capsule, cluster, provider, base_solver, settings
            )
        else:
            # the deprovisioner inspects its solver's concrete type (quality-
            # budget race construction, per-worker clones): hand it the REAL
            # solver, not the digest tap — deprov diffs compare actions, not
            # digest sequences
            replayed = _replay_deprovisioning(
                capsule, cluster, provider, base_solver, settings
            )
        # the tee sees every admission in round order, immune to ring bounds
        replayed["decisions"] = [r.to_dict() for r in decision_tee.records]
        replayed["problem_digests"] = list(tap.digests)

    recorded = capsule.get("outputs", {})
    report: Dict = {
        "capsule_id": capsule.get("id", ""),
        "controller": controller_kind,
        "counterfactual": counterfactual,
        "replayed": replayed,
        "recorded": {
            k: recorded.get(k)
            for k in ("problem_digests", "placements", "cost_delta",
                      "unschedulable", "gang_deferred", "validation_events",
                      "action", "planned", "decisions", "rebalance_actions")
            if k in recorded
        },
    }
    # a crashed round (anomaly reconcile-error) committed its capsule from
    # the EXCEPTION path: inputs + the digests/decisions recorded up to the
    # crash are real, but the round-result outputs (placements,
    # unschedulable, actions) were never set. The replay completes the round
    # the crash cut short, so the verdict compares the recorded PREFIX —
    # recorded digests must be a byte-identical prefix of the replayed
    # stream — and skips the absent result sections instead of failing a
    # completed replay against None.
    truncated = (
        recorded.get("error") is not None
        and "placements" not in recorded
        and "action" not in recorded
        and "rebalance_actions" not in recorded
    )
    report["truncated_by_error"] = truncated
    diffs: Dict = {}
    if controller_kind == "provisioning":
        rec_digests = recorded.get("problem_digests", [])
        if truncated:
            diffs["digests_match"] = (
                replayed["problem_digests"][: len(rec_digests)] == rec_digests
            )
        else:
            diffs["digests_match"] = rec_digests == replayed["problem_digests"]
        rec_place = {
            pod: _placement_key(e)
            for pod, e in (recorded.get("placements") or {}).items()
        }
        rep_place = {
            pod: _placement_key(e)
            for pod, e in (replayed.get("placements") or {}).items()
        }
        diffs["placements_match"] = rec_place == rep_place
        diffs["placement_diffs"] = {
            pod: {"recorded": rec_place.get(pod), "replayed": rep_place.get(pod)}
            for pod in set(rec_place) | set(rep_place)
            if rec_place.get(pod) != rep_place.get(pod)
        }
        diffs["unschedulable_match"] = (
            sorted(recorded.get("unschedulable", []))
            == sorted(replayed.get("unschedulable", []))
        )
        # gang deferral is a round OUTPUT like unschedulable: a replay that
        # defers a different member set diverged even when digests and bound
        # placements agree (pre-gang capsules lack the key on both sides)
        diffs["gang_deferred_match"] = (
            sorted(recorded.get("gang_deferred", []))
            == sorted(replayed.get("gang_deferred", []))
        )
        # validator verdicts + backend-degradation events are round OUTPUTS:
        # a replay that validated a different number of plans, or degraded
        # on a different round, diverged even when placements agree. The
        # `backend` field is EXCLUDED from the comparison like the aot
        # stats: which backend won a round's race legitimately varies with
        # executable-cache state across processes, while the verdict
        # sequence and the violations must not. Pre-firewall capsules lack
        # the key — skipped, not failed.
        rec_val = recorded.get("validation_events")
        diffs["validation_match"] = (
            True if rec_val is None
            else _validation_keys(rec_val)
            == _validation_keys(replayed.get("validation_events"))
        )
        # the round's ledger delta is a pure function of the launched
        # offerings and the capsule catalog prices, so it must reproduce
        # byte-identically — EXCEPT under price overrides, where diverging
        # is the point (the replayed value answers "what would that round
        # have cost at counterfactual prices"); pre-ledger capsules lack
        # the key — skipped, not failed
        rec_cost = recorded.get("cost_delta")
        diffs["cost_delta_match"] = (
            True if rec_cost is None or report.get("counterfactual")
            else rec_cost == replayed.get("cost_delta")
        )
        rec_keys = _decision_keys(recorded.get("decisions", []))
        rep_keys = _decision_keys(replayed.get("decisions", []))
        diffs["decisions_match"] = rec_keys == rep_keys
        if truncated:
            # only the digest prefix is comparable; result sections and the
            # decision multiset (a prefix of an unordered set is not
            # checkable) never existed on the recorded side
            report["match"] = diffs["digests_match"]
        else:
            report["match"] = (
                diffs["digests_match"]
                and diffs["placements_match"]
                and diffs["unschedulable_match"]
                and diffs["gang_deferred_match"]
                and diffs["validation_match"]
                and diffs["cost_delta_match"]
            )
    elif controller_kind == "rebalance":
        # rebalance rounds compare the full ordered action list — pool,
        # replacement offering AND replacement node name (the machine-name
        # sequence is pinned, so names are replayable identity here)
        diffs["rebalance_actions_match"] = (
            (recorded.get("rebalance_actions") or [])
            == (replayed.get("rebalance_actions") or [])
        )
        rec_keys = _decision_keys(recorded.get("decisions", []))
        rep_keys = _decision_keys(replayed.get("decisions", []))
        diffs["decisions_match"] = rec_keys == rep_keys
        report["match"] = True if truncated else diffs["rebalance_actions_match"]
    else:
        rec_action = recorded.get("action") or recorded.get("planned")
        rep_action = replayed.get("action") or replayed.get("planned")
        diffs["action_match"] = _actions_equal(rec_action, rep_action)
        report["match"] = True if truncated else diffs["action_match"]
    report["diffs"] = diffs
    return report


def _replay_federation(
    capsule: Dict,
    counterfactual: bool,
    forbid_network: bool = True,
    solver: Optional[str] = None,
    device: str = "cuda",
) -> Dict:
    """Replay one federated round: re-run the arbiter's PURE verdict
    function over the capsule's recorded inputs (requests in recorded
    order, degraded requests included) and byte-compare verdict + digest;
    then recursively replay every per-cluster sub-capsule. ``match`` is the
    conjunction — a federated round only matches when the global routing
    AND every local round reproduce. The port's difference: each
    sub-capsule replays through the caller's solver name and ``device``, so
    ``--solver torch`` replays a card round's sub-capsule on the card."""
    from .federation.arbiter import arbiter_verdict

    inputs = capsule.get("inputs", {})
    recorded_verdict = capsule.get("outputs", {}).get("verdict", {}) or {}
    replayed_verdict = arbiter_verdict(inputs)
    verdict_match = (
        replayed_verdict.get("digest") == recorded_verdict.get("digest")
        and replayed_verdict.get("assignments")
        == recorded_verdict.get("assignments")
        and replayed_verdict.get("rebalance")
        == recorded_verdict.get("rebalance")
    )
    sub_reports: List[Dict] = []
    for sub in capsule.get("sub_capsules", []):
        # sub-capsules replay WITHOUT the federation overrides: a cluster
        # counterfactual changes where units would route, not what a
        # recorded local round actually solved
        report = replay_capsule(
            dict(sub.get("capsule") or {}),
            forbid_network=forbid_network, solver=solver, device=device,
        )
        sub_reports.append({
            "cluster": sub.get("cluster", ""),
            "capsule_id": report.get("capsule_id", ""),
            "match": report.get("match"),
            "diffs": report.get("diffs", {}),
        })
    subs_match = all(r["match"] for r in sub_reports)
    degraded = [
        a for a in replayed_verdict.get("assignments", [])
        if a.get("outcome") == "degraded-local"
    ]
    return {
        "capsule_id": capsule.get("id", ""),
        "controller": "federation",
        "counterfactual": counterfactual,
        "epoch": replayed_verdict.get("epoch"),
        "replayed": {"verdict": replayed_verdict},
        "recorded": {"verdict": recorded_verdict},
        "truncated_by_error": False,
        "sub_reports": sub_reports,
        "diffs": {
            "verdict_match": verdict_match,
            "digest_recorded": recorded_verdict.get("digest"),
            "digest_replayed": replayed_verdict.get("digest"),
            "sub_capsules_match": subs_match,
            "degraded_assignments": len(degraded),
        },
        "match": verdict_match and subs_match,
    }


def _actions_equal(a: Optional[Dict], b: Optional[Dict]) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (
        a.get("reason") == b.get("reason")
        and sorted(a.get("nodes", [])) == sorted(b.get("nodes", []))
        and sorted(
            (r["instance_type"], r["zone"], r["capacity_type"])
            for r in a.get("replacements", [])
        )
        == sorted(
            (r["instance_type"], r["zone"], r["capacity_type"])
            for r in b.get("replacements", [])
        )
    )


def _replay_provisioning(capsule, cluster, provider, solver, settings) -> Dict:
    from contextlib import nullcontext

    from .controllers.provisioning import MachineNameSeq, ProvisioningController
    from .solver.validate import scripted_verdicts
    from .utils.flightrecorder import provisioning_outputs

    controller = ProvisioningController(
        cluster, provider, solver=solver, settings=settings
    )
    # launched-node names reproduce the recorded sequence (they feed later
    # solve rounds' digests and the placement records)
    controller.machine_ids = MachineNameSeq(capsule.get("machine_seq", 1))
    # the firewall's fallback re-solves add digests to the recorded stream
    # (cap.add_digest on the live side): route the replay's fallback solver
    # through a tap SHARING the main tap's list, so the replayed digest
    # sequence interleaves in the same call order
    if isinstance(solver, _DigestTapSolver):
        from .controllers.provisioning import clone_solver
        from .solver.solver import GreedySolver as _Greedy

        fallback_tap = _DigestTapSolver(_Greedy())
        fallback_tap.digests = solver.digests
        controller._fw_fallback = fallback_tap
        if controller.cells is not None:
            # Differs from the reference, where the tap cannot be cloned and
            # every cell shares it: cells solve on clones of the replay's
            # solver, as the recorded round's cells solved on clones of its
            # own, so a fleet of cells is batched again and races as it did.
            # Each clone's tap shares the main tap's list; one worker keeps
            # the list in the round's cell order (the worker count never
            # changes an answer).
            def clone_cell_solver():
                clone = clone_solver(solver._inner)
                if clone is None:
                    return None
                tap = _DigestTapSolver(clone)
                tap.digests = solver.digests
                return tap

            controller._clone_solver = clone_cell_solver
            settings.cell_shard_workers = 1
    # a recorded firewall REJECTION came from a transient device fault the
    # offline replay cannot reproduce — install the recorded verdict
    # sequence so the firewall consumes it in call order and the round's
    # fallback decision (and every digest downstream) replays
    # byte-identically. All-accepted capsules validate live: the real
    # computation is itself deterministic then.
    recorded_events = capsule.get("outputs", {}).get("validation_events") or []
    script = (
        scripted_verdicts(recorded_events)
        if any(e.get("verdict") != "accepted" for e in recorded_events)
        else nullcontext()
    )
    with script:
        result = controller.reconcile()
    return provisioning_outputs(result, cluster, provider.pricing)


def _replay_rebalance(capsule, cluster, provider, solver, settings) -> Dict:
    """Re-run a rebalance round offline: the recorded queue messages refeed
    verbatim (garbage included), pending rebalances restore with their
    remaining deadlines against a pinned clock, the machine-name sequence
    pins to the capsule, and the capsule catalog — interruption
    probabilities included — serves the replacement-pool choice. The
    replayed action list must equal the recorded one byte-for-byte."""
    from .controllers.interruption import (
        FakeQueue, InterruptionController, PendingRebalance,
    )
    from .controllers.provisioning import MachineNameSeq, ProvisioningController
    from .controllers.termination import TerminationController
    from .utils.cache import FakeClock
    from .utils.events import Recorder

    inputs = capsule.get("inputs", {})
    clock = FakeClock(capsule.get("clock_now", 0.0))
    recorder = Recorder()
    termination = TerminationController(
        cluster, provider, recorder=recorder, clock=clock
    )
    prov_ctl = ProvisioningController(
        cluster, provider, solver=solver, settings=settings
    )
    queue = FakeQueue()
    for body in inputs.get("queue_messages", []):
        queue.send_raw(body)
    controller = InterruptionController(
        cluster, queue, termination,
        unavailable_offerings=provider.unavailable_offerings,
        recorder=recorder,
        provisioning=prov_ctl,
        provider=provider,
        settings=settings,
        clock=clock,
    )
    controller.machine_ids = MachineNameSeq(capsule.get("machine_seq", 1))
    prov_ctl.machine_ids = controller.machine_ids
    for ent in inputs.get("rebalance_pending", []):
        controller._rebalances[ent["node"]] = PendingRebalance(
            node=ent["node"],
            pool=tuple(ent["pool"]),
            replacement=ent["replacement"],
            deadline=clock.now() + float(ent.get("deadline_remaining", 0.0)),
        )
    controller.reconcile(max_messages=max(len(queue), 10))
    # canonical (node, action) order: the capsule recorded _sorted_actions()
    # (worker-pool append order is scheduler-dependent), so the replayed list
    # must be compared in the same ordering
    return {"rebalance_actions": controller._sorted_actions()}


def _pending_action_from_wire(wire: Dict, cluster, provider, clock, settings):
    """Rebuild the matured PlannedAction the recorded pass was validating —
    replacements included (offering + provisioner + pod names are all in the
    wire) — stamped old enough that the validation window has elapsed."""
    from .api.resources import Resources
    from .controllers.deprovisioning import PlannedAction
    from .solver.encode import LaunchOption
    from .solver.result import NewNodeSpec

    replacements = []
    for r in wire.get("replacements", []):
        prov = cluster.provisioners.get(r.get("provisioner", ""))
        it = next(
            (t for t in provider.get_instance_types(prov)
             if t.name == r["instance_type"]),
            None,
        )
        if prov is None or it is None:
            return None  # catalog/provisioner drifted out from under the plan
        option = LaunchOption(
            provisioner=prov, instance_type=it, zone=r["zone"],
            capacity_type=r["capacity_type"], price=r.get("price", 0.0),
            node_requirements=it.requirements, taints=tuple(prov.taints),
            allocatable=it.allocatable(),
        )
        replacements.append(
            NewNodeSpec(option=option, pod_names=list(r.get("pod_names", [])))
        )
    return PlannedAction(
        reason=wire["reason"], nodes=list(wire.get("nodes", [])),
        replacements=replacements,
        created=clock.now() - settings.consolidation_validation_ttl - 1.0,
        savings=wire.get("savings", 0.0),
        evict_pods=list(wire.get("evict_pods", [])),
        gangs=list(wire.get("gangs", [])),
    )


def _replay_deprovisioning(capsule, cluster, provider, solver, settings) -> Dict:
    from .controllers.deprovisioning import DeprovisioningController
    from .controllers.termination import TerminationController
    from .utils.cache import FakeClock
    from .utils.events import Recorder
    from .utils.flightrecorder import action_to_wire

    inputs = capsule.get("inputs", {})
    clock = FakeClock(capsule.get("clock_now", 0.0))
    recorder = Recorder()
    termination = TerminationController(cluster, provider, recorder=recorder, clock=clock)
    controller = DeprovisioningController(
        cluster, provider, termination, solver=solver,
        settings=settings, recorder=recorder, clock=clock,
    )
    from .controllers.provisioning import MachineNameSeq

    controller.machine_ids = MachineNameSeq(capsule.get("machine_seq", 1))
    notes: List[str] = []
    had_pending = inputs.get("had_pending_action")
    if had_pending:
        # the recorded pass validated (then executed or aborted) a MATURED
        # plan: reconstruct that exact plan and replay the SAME path —
        # deriving a fresh plan from the (moved) cluster would compare
        # apples to oranges whenever the cluster drifted during the TTL
        controller.pending_action = _pending_action_from_wire(
            had_pending, cluster, provider, clock, settings
        )
        if controller.pending_action is None:
            # the captured catalog/provisioners no longer carry the plan's
            # replacement: the replay falls back to fresh derivation — say
            # so loudly, or an action_match=False here reads as solver
            # non-determinism instead of what it is
            notes.append(
                "recorded pending plan not reconstructible from the capsule "
                "catalog; replayed a FRESH derivation instead of the "
                "matured-plan validation path"
            )
    remaining = float(inputs.get("stabilization_remaining", 0.0) or 0.0)
    if remaining > 0:
        controller._last_node_change = clock.now() - (
            settings.stabilization_window - remaining
        )
    else:
        controller._last_node_change = float("-inf")
    action = controller.reconcile()
    out = {
        "action": action_to_wire(action),
        "planned": action_to_wire(controller.pending_action),
    }
    if notes:
        out["notes"] = notes
    return out


# ---------------------------------------------------------------------------
# --explain rendering
# ---------------------------------------------------------------------------

def explain_pod(report: Dict, pod: str) -> str:
    """Render the placement verdict + rejected-alternatives table for one pod
    from the replayed decisions (fall back to the recorded ones)."""
    for source, decisions in (
        ("replayed", report.get("replayed", {}).get("decisions", [])),
        ("recorded", report.get("recorded", {}).get("decisions", []) or []),
    ):
        records = [
            d for d in decisions
            if d.get("kind") == "placement" and d.get("pod") == pod
        ]
        if records:
            return _render_placement(records[-1], source)
    return f"no placement record for pod {pod!r} in this capsule"


def _render_placement(rec: Dict, source: str) -> str:
    details = rec.get("details", {})
    lines = [f"pod {rec.get('pod')}: {rec.get('outcome')} ({source})"]
    if rec.get("outcome") == "unschedulable":
        lines.append(f"  reason: {rec.get('reason', '')}")
        return "\n".join(lines)
    if rec.get("node"):
        lines.append(f"  node: {rec['node']}")
    if details.get("instance_type"):
        lines.append(
            "  chosen: {it} / {zone} / {ct} @ ${price}/h".format(
                it=details.get("instance_type"), zone=details.get("zone"),
                ct=details.get("capacity_type"), price=details.get("price"),
            )
        )
    alts = details.get("rejected_alternatives", [])
    if alts:
        lines.append("  rejected alternatives:")
        header = f"    {'instance_type':<20} {'zone':<14} {'capacity_type':<14} {'price':>9}  reason"
        lines.append(header)
        for a in alts:
            lines.append(
                f"    {a.get('instance_type', ''):<20} {a.get('zone', ''):<14} "
                f"{a.get('capacity_type', ''):<14} {a.get('price', 0):>9}  "
                f"{a.get('reason', '')}"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.replay",
        description="Replay a flight-recorder capsule offline and diff "
                    "against the recorded round.",
    )
    ap.add_argument("capsule", help="path to a capsule (.json or .json.gz)")
    ap.add_argument("--explain", default=None, metavar="pod=<name>",
                    help="render the placement verdict + rejected-"
                         "alternatives table for one pod")
    ap.add_argument("--override", action="append", default=[],
                    help="counterfactual knob (repeatable): settings.<f>=<v>, "
                         "offerings=<type>/<zone>/<ct>=available|unavailable|"
                         "price:<x>, risk.<type>/<zone>/<ct>=<p>, "
                         "provisioner.<name>.limits.<res>=<qty>, "
                         "provisioner.<name>.weight=<n>; federation capsules: "
                         "cluster.<name>.available=<bool>, "
                         "cluster.<name>.risk.<pool-or-*>=<p>")
    ap.add_argument("--solver", default=None, choices=("tpu", "greedy"),
                    help="override the recorded solver")
    ap.add_argument("--device", default="cuda",
                    help="device of the replay's TorchSolver (default cuda; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--json", action="store_true", help="emit the full report as JSON")
    ap.add_argument("--allow-network", action="store_true",
                    help="drop the zero-network guard (debugging only)")
    args = ap.parse_args(argv)

    try:
        capsule = load_capsule(args.capsule)
    except (OSError, ValueError) as e:
        print(f"cannot load capsule: {e}", file=sys.stderr)
        return 1
    try:
        report = replay_capsule(
            capsule, overrides=args.override,
            forbid_network=not args.allow_network, solver=args.solver,
            device=args.device,
        )
    except OverrideError as e:
        print(f"bad override: {e}", file=sys.stderr)
        return 1

    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        _print_summary(report)
    if args.explain:
        pod = args.explain.partition("=")[2] or args.explain
        print()
        print(explain_pod(report, pod))
    if report.get("counterfactual"):
        return 0
    return 0 if report.get("match") else 2


def _print_summary(report: Dict) -> None:
    mode = "counterfactual" if report["counterfactual"] else "replay"
    verdict = (
        "MATCH" if report.get("match")
        else ("DIVERGED" if not report["counterfactual"] else "—")
    )
    print(f"{mode} of capsule {report['capsule_id']} ({report['controller']}): {verdict}")
    if report.get("truncated_by_error"):
        print("  (recorded round crashed mid-reconcile: verdict compares the "
              "recorded prefix; result sections below never existed recorded-side)")
    diffs = report.get("diffs", {})
    if report["controller"] == "provisioning":
        rec = report.get("recorded", {})
        rep = report.get("replayed", {})
        print(f"  digests: recorded={len(rec.get('problem_digests') or [])} "
              f"replayed={len(rep.get('problem_digests') or [])} "
              f"byte_equal={diffs.get('digests_match')}")
        print(f"  placements: {len(rep.get('placements') or {})} pods, "
              f"equal={diffs.get('placements_match')}")
        for pod, d in sorted(diffs.get("placement_diffs", {}).items()):
            print(f"    {pod}: recorded={d['recorded']} replayed={d['replayed']}")
        print(f"  unschedulable: recorded={len(rec.get('unschedulable') or [])} "
              f"replayed={len(rep.get('unschedulable') or [])} "
              f"equal={diffs.get('unschedulable_match')}")
        print(f"  gang_deferred: recorded={len(rec.get('gang_deferred') or [])} "
              f"replayed={len(rep.get('gang_deferred') or [])} "
              f"equal={diffs.get('gang_deferred_match')}")
        rec_val = rec.get("validation_events") or []
        rejected = sum(1 for e in rec_val if e.get("verdict") != "accepted")
        print(f"  validation: recorded={len(rec_val)} events "
              f"({rejected} rejected) "
              f"equal={diffs.get('validation_match')}")
        rep_cost = rep.get("cost_delta")
        if rep_cost is not None:
            rec_cost = rec.get("cost_delta") or {}
            print(f"  cost_delta: recorded={rec_cost.get('actual_per_hr')}$/hr "
                  f"replayed={rep_cost.get('actual_per_hr')}$/hr "
                  f"(ondemand={rep_cost.get('ondemand_per_hr')}$/hr) "
                  f"equal={diffs.get('cost_delta_match')}")
        print(f"  decisions: equal={diffs.get('decisions_match')}")
    elif report["controller"] == "federation":
        verdict = report.get("replayed", {}).get("verdict", {})
        print(f"  epoch: {report.get('epoch')}  "
              f"assignments: {len(verdict.get('assignments') or [])} "
              f"({diffs.get('degraded_assignments', 0)} degraded-local)  "
              f"rebalance: {len(verdict.get('rebalance') or [])}")
        print(f"  verdict digest: recorded={diffs.get('digest_recorded')} "
              f"replayed={diffs.get('digest_replayed')} "
              f"equal={diffs.get('verdict_match')}")
        for sub in report.get("sub_reports", []):
            print(f"  sub-capsule {sub['capsule_id']} "
                  f"({sub['cluster']}): match={sub['match']}")
        print(f"  sub_capsules_match={diffs.get('sub_capsules_match')}")
    elif report["controller"] == "rebalance":
        rep = report.get("replayed", {})
        for a in rep.get("rebalance_actions") or []:
            print(f"  {a.get('action')}: {a.get('node')} "
                  f"(pool {'/'.join(a.get('pool', []))})")
        print(f"  rebalance_actions_match={diffs.get('rebalance_actions_match')}")
    else:
        rep = report.get("replayed", {})
        print(f"  action: {rep.get('action') or rep.get('planned')}")
        print(f"  action_match={diffs.get('action_match')}")


if __name__ == "__main__":
    sys.exit(main())
