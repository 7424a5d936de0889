"""Stateful fake cloud provider.

The backbone of the test pyramid, mirroring the reference's fake EC2
(upstream ``pkg/fake/ec2api.go:39-150``): stateful launches, injectable
insufficient-capacity pools (ICE), injectable next-call errors, and a generated
instance-type catalog — so ICE fallback, unavailable-offering caching, and drift
paths are exercisable hermetically.

Launch semantics follow the reference's instance provider
(upstream ``pkg/providers/instance/instance.go``): filter candidate types by
requirement compatibility and resource fit, choose spot when the machine allows it
and a spot offering exists (``:411-424``), order offerings by price (``:426-443``),
skip offerings marked unavailable, and on ICE mark the offering in the
unavailable-offerings cache and fall through to the next-cheapest (``:400-406``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as wk
from ..api.objects import Machine, MachineStatus, Provisioner
from ..api.requirements import Requirements
from ..utils.cache import UnavailableOfferings
from .catalog import generate_catalog
from .interface import (
    CloudProvider,
    CloudProviderError,
    Image,
    InsufficientCapacityError,
    WindowedBatchers,
    Instance,
    MachineNotFoundError,
    SecurityGroup,
    Subnet,
)
from .types import InstanceType, Offering

OfferingKey = Tuple[str, str, str]  # (instance_type, zone, capacity_type)


class FakeCloudProvider(WindowedBatchers, CloudProvider):
    def __init__(
        self,
        catalog: Optional[List[InstanceType]] = None,
        unavailable_offerings: Optional[UnavailableOfferings] = None,
        max_instance_types: int = 60,
        fault_plan=None,
    ):
        self.catalog = catalog if catalog is not None else generate_catalog()
        self._by_name = {it.name: it for it in self.catalog}
        self.unavailable_offerings = unavailable_offerings or UnavailableOfferings()
        # scripted per-endpoint failures (utils/faults.FaultPlan): create/
        # terminate/describe/list consume one fault per call — the
        # deterministic analogue of inject_next_error for resilience tests
        self.fault_plan = fault_plan
        # (type, zone, capacity_type) pools that will ICE on launch — the analogue of
        # fake EC2's InsufficientCapacityPools (upstream pkg/fake/ec2api.go:107-150).
        self.insufficient_capacity_pools: Set[OfferingKey] = set()
        self.next_errors: List[Exception] = []
        self.instances: Dict[str, Instance] = {}
        # Network/image inventory resolved by the nodetemplate controller
        # (reference subnet/securitygroup/ami providers, pkg/providers/{subnet,
        # securitygroup,amifamily}); shared with the HTTP cloud so selector
        # resolution cannot diverge between backends (inventory.py).
        from .inventory import default_inventory

        zones = sorted({o.zone for it in self.catalog for o in it.offerings})
        (self.subnets, self.security_groups, self.images,
         self.current_images) = default_inventory(zones)
        from .subnet import SubnetProvider

        self.subnet_provider = SubnetProvider(self.subnets)
        # Provider-side launch templates (hash-named; see launchtemplate.py)
        self.launch_templates: Dict[str, object] = {}
        # Wired by the operator: NodeTemplate name -> NodeTemplate, so create()
        # can resolve launch configs the way the reference cloudprovider fetches
        # the AWSNodeTemplate by ref inside Create.
        self.node_template_lookup: Optional[Callable[[str], object]] = None
        self._lt_provider = None  # lazy LaunchTemplateProvider
        self.create_calls: List[Machine] = []
        self.delete_calls: List[str] = []
        self.launch_attempts = 0
        self.max_instance_types = max_instance_types
        self._id_counter = itertools.count(1)
        self._lock = threading.Lock()
        # Seqnum-keyed instance-type cache (reference: multi-level cache keyed
        # on seqnums+hashes, pkg/providers/instancetype/instancetype.go:95-107).
        # Returning the SAME list object until something changes lets the
        # encoder's option cache skip re-flattening 400 types x offerings.
        self.catalog_version = 0
        self._it_cache: Dict[Optional[str], tuple] = {}
        # Live pricing over the catalog's static anchors (pricing.go:85);
        # get_instance_types serves offerings at current prices and its cache
        # key includes pricing.version, so a refresh invalidates consumers.
        from .pricing import CapacityPoolProvider, PricingProvider

        self.pricing = PricingProvider(self.catalog)
        # Capacity-pool risk axis: when the operator (or a test) attaches an
        # InterruptionRiskCache via ``attach_risk_cache``, get_instance_types
        # stamps each offering's interruption_probability from it — the same
        # pattern as the ICE mask riding ``available``. None = risk off, and
        # every offering keeps probability 0.0 (legacy digests unchanged).
        self.risk_cache = None
        self.pools = CapacityPoolProvider(self.pricing, None)
        # CreateFleet-style batcher: concurrent create() calls with the same
        # launch shape coalesce into one fleet call (createfleet.go:33-110,
        # windows batcher.go:29-35 — 35ms idle / 1s max / 1000 items).
        from ..utils.batcher import Batcher, BatcherOptions

        self.create_fleet_calls = 0
        self._fleet_batcher = Batcher(
            request_hasher=_fleet_hash,
            batch_executor=self._execute_fleet,
            options=BatcherOptions(idle_timeout=0.035, max_timeout=1.0, max_items=1000),
        )
        # Terminate/Describe batching comes from the WindowedBatchers mixin
        # (reference batches all three hot calls, terminateinstances.go:36-38,
        # describeinstances.go:37-39). Counters record BACKEND calls — a
        # 200-instance consolidation should bump terminate_calls once.
        self.terminate_calls = 0
        self.describe_calls = 0

    # -- test injection ----------------------------------------------------
    def set_catalog(self, catalog: List[InstanceType]) -> None:
        """Replace the instance-type catalog, bumping catalog_version so every
        downstream cache (instance-type lists, encoder option tables) sees the
        change — direct mutation of ``self.catalog`` would be served stale for
        up to the cache staleness bucket (advisor round-2 finding).

        Already-launched instances keep their (now-retired) type definitions
        so get/list/conversion still work until they terminate, and subnets
        are created for any zone new to the catalog (existing subnets keep
        their IP accounting)."""
        with self._lock:
            old_by_name = self._by_name
            self.catalog = catalog
            self._by_name = {it.name: it for it in catalog}
            for inst in self.instances.values():
                if inst.instance_type not in self._by_name and inst.instance_type in old_by_name:
                    self._by_name[inst.instance_type] = old_by_name[inst.instance_type]
            known_zones = {s.zone for s in self.subnets}
            for z in sorted({o.zone for it in catalog for o in it.offerings} - known_zones):
                subnet = Subnet(
                    id=f"subnet-{z}", zone=z,
                    tags={"karpenter.tpu/discovery": "cluster", "zone": z},
                )
                self.subnets.append(subnet)
                self.subnet_provider._subnets[subnet.id] = subnet
            self.catalog_version += 1
            # in place: PricingController holds a reference to this object
            self.pricing.reload(catalog)

    def attach_risk_cache(self, risk_cache) -> None:
        """Wire an InterruptionRiskCache so offerings carry live
        interruption probabilities (risk version joins the catalog cache
        key, so a recorded reclaim invalidates instance-type lists the way
        an ICE mark does)."""
        self.risk_cache = risk_cache
        self.pools.risk = risk_cache

    def enable_slice_topology(self) -> None:
        """Expand the catalog's TPU-type offerings into per-coordinate slice
        offerings (solver/topology.py) — the fake's analogue of a TPU API
        serving topology descriptors. Idempotent (already-expanded offerings
        pass through); bumps catalog_version via set_catalog so every
        downstream cache sees the new axis."""
        from ..solver.topology import with_slice_topology

        self.set_catalog(with_slice_topology(self.catalog))

    def set_insufficient_capacity(self, instance_type: str, zone: str, capacity_type: str) -> None:
        self.insufficient_capacity_pools.add((instance_type, zone, capacity_type))

    def clear_insufficient_capacity(self) -> None:
        self.insufficient_capacity_pools.clear()

    def inject_next_error(self, error: Exception) -> None:
        self.next_errors.append(error)

    def _apply_fault(self, endpoint: str) -> None:
        """Consume one scripted fault for this endpoint, if any (raises
        TransientCloudError / InsufficientCapacityError or sleeps through
        the plan's injectable sleeper)."""
        if self.fault_plan is None:
            return
        from ..utils.faults import raise_for_fault

        raise_for_fault(self.fault_plan.next(endpoint), self.fault_plan, endpoint)

    def rotate_image(self, family: str = "default", variant: Optional[str] = None) -> str:
        """Advance the current image for (family, variant), making previously
        launched machines of that personality drifted."""
        key = family if variant is None else f"{family}/{variant}"
        current = self.current_images.get(key, "image-000")
        stem, n = current.rsplit("-", 1)
        nxt = f"{stem}-{int(n) + 1:03d}"
        self.current_images[key] = nxt
        tags = {"family": family}
        if variant is not None:
            tags["variant"] = variant
        self.images.append(
            Image(id=nxt, family=family, created=float(len(self.images) + 1), tags=tags)
        )
        return nxt

    # -- launch-template store (reference EC2 launch-template API surface,
    # used by launchtemplate.LaunchTemplateProvider) ------------------------
    def create_launch_template(self, config) -> None:
        self.launch_templates[config.name] = config

    def delete_launch_template(self, name: str) -> None:
        self.launch_templates.pop(name, None)

    def list_launch_templates(self) -> List[object]:
        return list(self.launch_templates.values())

    def list_images(self, family: str) -> List[Image]:
        """Image source for the resolver: images of one family, any variant."""
        return [i for i in self.images if i.tags.get("family") == family]

    @property
    def launch_template_provider(self):
        if self._lt_provider is None:
            # launch templates and image families come with the node-template
            # controller (ROADMAP.md, Queue 1 item 6)
            raise NotImplementedError(
                "launch templates are not ported yet: a machine that "
                "references a node template needs cloudprovider/launchtemplate.py "
                "and imagefamily.py (ROADMAP.md, Queue 1 item 6)"
            )
        return self._lt_provider

    # -- network/image discovery (selector = tag map; reference subnet.go:213-235,
    # securitygroup.go:53, ami.go:99-133) ---------------------------------
    def describe_subnets(self, selector: Dict[str, str]) -> List[Subnet]:
        return [s for s in self.subnets if _tags_match(s.tags, selector)]

    def describe_security_groups(self, selector: Dict[str, str]) -> List[SecurityGroup]:
        return [g for g in self.security_groups if _tags_match(g.tags, selector)]

    def describe_images(self, selector: Dict[str, str]) -> List[Image]:
        out = [i for i in self.images if _tags_match(i.tags, selector)]
        # newest-by-creation-date first (reference ami.go:236-245)
        return sorted(out, key=lambda i: -i.created)

    # -- CloudProvider -----------------------------------------------------
    @property
    def name(self) -> str:
        return "fake"

    def create_batched(self, machine: Machine) -> Machine:
        """create() through the fleet batcher: blocks until the machine's
        window executes; concurrent callers with the same launch shape share
        ONE fleet call. Per-machine failures come back as that caller's
        exception, exactly like the reference's per-instance CreateFleet
        errors (createfleet.go:68-89)."""
        result = self._fleet_batcher.add(machine)
        if isinstance(result, BaseException):
            raise result
        return result

    def _execute_fleet(self, machines: Sequence[Machine]) -> List[object]:
        self.create_fleet_calls += 1
        out: List[object] = []
        for m in machines:
            try:
                out.append(self.create(m))
            except Exception as e:
                out.append(e)
        return out

    def create(self, machine: Machine) -> Machine:
        """Launch through the shared policy module (launchpolicy.py): price
        ordering, spot-vs-OD, top-N truncation and the ICE fallback walk are
        provider-agnostic; this fake contributes only its instance store, its
        injected ICE pools, and subnet IP accounting."""
        from .launchpolicy import candidate_offerings, launch_with_fallback

        with self._lock:
            if self.next_errors:
                raise self.next_errors.pop(0)
            self._apply_fault("create")
            self.create_calls.append(machine)
            candidates = candidate_offerings(
                machine.requirements,
                machine.requests,
                self.catalog,
                price=self.pricing.price,
                is_unavailable=self.unavailable_offerings.is_unavailable,
                max_instance_types=self.max_instance_types,
            )
            if not candidates:
                raise InsufficientCapacityError(
                    f"no compatible offerings for machine {machine.name}"
                )

            def try_launch(it: InstanceType, offering: Offering) -> Machine:
                self.launch_attempts += 1
                key = (it.name, offering.zone, offering.capacity_type)
                if key in self.insufficient_capacity_pools:
                    # injected ICE: blacklisted by the fallback walk
                    raise InsufficientCapacityError(f"ICE pool {key}")
                return self._launch(machine, it, offering)

            return launch_with_fallback(
                machine,
                candidates,
                try_launch,
                lambda t, z, c, reason: self.unavailable_offerings.mark_unavailable(
                    t, z, c, reason=reason
                ),
            )

    def _resolve_launch_config(self, machine: Machine, it: InstanceType):
        """NodeTemplate -> resolved launch config for this machine+type, or None
        when no template is referenced (legacy default-image path). Mirrors the
        reference cloudprovider fetching the AWSNodeTemplate by ref and running
        EnsureAll inside Create (launchtemplate.go:89-135)."""
        if self.node_template_lookup is None or not machine.node_template_ref:
            return None
        nt = self.node_template_lookup(machine.node_template_ref)
        if nt is None:
            return None
        cfgs = self.launch_template_provider.ensure_all(
            nt,
            [it],
            taints=tuple(machine.taints),
            labels=_bootstrap_labels(machine.meta.labels),
            kubelet=machine.kubelet,
        )
        for cfg in cfgs:
            if cfg.covers(it.name):
                return cfg
        return cfgs[0] if cfgs else None

    def _launch(self, machine: Machine, it: InstanceType, offering: Offering) -> Machine:
        # zonal subnet by free IPs, with in-flight reservation (subnet.go:90,
        # :129); eligible subnets narrow to the template's resolved set
        eligible = None
        if self.node_template_lookup is not None and machine.node_template_ref:
            nt = self.node_template_lookup(machine.node_template_ref)
            if nt is not None and nt.resolved_subnets:
                eligible = nt.resolved_subnets
        subnet = self.subnet_provider.zonal_subnet_for_launch(
            offering.zone, eligible_ids=eligible
        )
        try:
            return self._launch_in_subnet(machine, it, offering, subnet)
        except Exception:
            self.subnet_provider.release_inflight(subnet.id)
            raise

    def _launch_in_subnet(
        self, machine: Machine, it: InstanceType, offering: Offering, subnet: Subnet
    ) -> Machine:
        instance_id = f"i-{next(self._id_counter):08d}"
        cfg = self._resolve_launch_config(machine, it)
        if cfg is not None:
            image = cfg.image_id
        else:
            image = self.current_images.get("default", "image-001")
        instance = Instance(
            id=instance_id,
            instance_type=it.name,
            zone=offering.zone,
            capacity_type=offering.capacity_type,
            image_id=image,
            tags={wk.MANAGED_BY: "karpenter-tpu", wk.PROVISIONER_NAME: machine.provisioner_name},
            created=time.time(),
            launch_template=cfg.name if cfg is not None else "",
            image_family=cfg.family if cfg is not None else "",
            image_variant=cfg.variant if cfg is not None else "",
        )
        instance.tags["subnet"] = subnet.id
        self.subnet_provider.commit(subnet.id)
        self.instances[instance_id] = instance
        machine.status = MachineStatus(
            provider_id=f"fake:///{offering.zone}/{instance_id}",
            capacity=it.capacity,
            allocatable=it.allocatable(),
            launched=True,
        )
        # Stamp concrete labels the node will carry (instanceToMachine,
        # upstream pkg/cloudprovider/cloudprovider.go:306-337).
        machine.meta.labels.update(it.requirements.labels())
        machine.meta.labels[wk.INSTANCE_TYPE] = it.name
        machine.meta.labels[wk.ZONE] = offering.zone
        machine.meta.labels[wk.CAPACITY_TYPE] = offering.capacity_type
        machine.meta.labels[wk.PROVISIONER_NAME] = machine.provisioner_name
        if offering.slice_pod:
            # slice identity rides the node as labels: the encoder's node
            # surfaces, slice-pinned nodeSelectors and hop-distance scoring
            # all read the same karpenter.tpu/slice-* pair
            from ..solver.topology import format_coord

            machine.meta.labels[wk.SLICE_POD] = offering.slice_pod
            instance.tags[wk.SLICE_POD] = offering.slice_pod
            if offering.slice_coord is not None:
                coord = format_coord(offering.slice_coord)
                machine.meta.labels[wk.SLICE_COORD] = coord
                instance.tags[wk.SLICE_COORD] = coord
        if cfg is not None:
            machine.meta.annotations[wk.LAUNCH_TEMPLATE_ANNOTATION] = cfg.name
        return machine

    def delete(self, machine: Machine) -> None:
        with self._lock:
            self.terminate_calls += 1  # an unbatched TerminateInstances call
            self._delete_locked(machine)

    def _delete_locked(self, machine: Machine) -> None:
        instance_id = _instance_id(machine.status.provider_id)
        self.delete_calls.append(instance_id)
        if instance_id not in self.instances:
            raise MachineNotFoundError(f"instance {instance_id} not found")
        instance = self.instances[instance_id]
        instance.state = "terminated"
        subnet_id = instance.tags.get("subnet")
        if subnet_id:
            self.subnet_provider.release_ip(subnet_id)
        del self.instances[instance_id]

    def delete_many(self, machines: Sequence[Machine]) -> List[Optional[Exception]]:
        """One TerminateInstances call for a caller-aggregated set (the
        termination finalizer knows its whole teardown set up front, so it
        needs no batching window)."""
        return self._execute_terminate(machines)

    def _execute_terminate(self, machines: Sequence[Machine]) -> List[Optional[Exception]]:
        out: List[Optional[Exception]] = []
        with self._lock:
            self._apply_fault("terminate")
            self.terminate_calls += 1  # ONE backend call for the whole set
            for m in machines:
                try:
                    self._delete_locked(m)
                    out.append(None)
                except Exception as e:  # noqa: BLE001 - per-item isolation
                    out.append(e)
        return out

    def _execute_describe(self, provider_ids: Sequence[str]) -> List[object]:
        out: List[object] = []
        with self._lock:
            self._apply_fault("describe")
            self.describe_calls += 1
            for pid in provider_ids:
                instance = self.instances.get(_instance_id(pid))
                if instance is None:
                    out.append(MachineNotFoundError(f"{pid} not found"))
                else:
                    out.append(self._instance_to_machine(instance))
        return out

    def get(self, provider_id: str) -> Machine:
        with self._lock:
            instance = self.instances.get(_instance_id(provider_id))
            if instance is None:
                raise MachineNotFoundError(f"{provider_id} not found")
            return self._instance_to_machine(instance)

    def list(self) -> List[Machine]:
        with self._lock:
            self._apply_fault("list")
            return [self._instance_to_machine(i) for i in self.instances.values()]

    def get_instance_types(self, provisioner: Optional[Provisioner]) -> List[InstanceType]:
        """Catalog filtered to the provisioner's requirements with current
        availability masks applied (GetInstanceTypes + resolveInstanceTypes,
        cloudprovider.go:155-170,254-273). Cached per provisioner keyed on the
        ICE-cache seqnum + catalog version + a 60s staleness bucket (TTL-expired
        ICE entries come back without a seqnum bump, as in the reference)."""
        pname = provisioner.name if provisioner is not None else None
        key = (
            pname,
            provisioner.meta.resource_version if provisioner is not None else None,
            self.unavailable_offerings.seqnum,
            self.catalog_version,
            self.pools.version,  # covers pricing.version + risk-cache writes
            int(time.time() // 60),
        )
        cached = self._it_cache.get(pname)
        if cached is not None and cached[0] == key:
            return cached[1]
        out: List[InstanceType] = []
        for it in self.catalog:
            if provisioner is not None and not it.requirements.compatible(provisioner.requirements):
                continue
            offerings = [
                Offering(
                    zone=o.zone,
                    capacity_type=o.capacity_type,
                    price=self.pricing.price(it.name, o.zone, o.capacity_type) or o.price,
                    available=o.available
                    and not self.unavailable_offerings.is_unavailable(
                        it.name, o.zone, o.capacity_type
                    ),
                    interruption_probability=self.pools.probability(
                        it.name, o.zone, o.capacity_type
                    ),
                    # slice identity passes through: price/ICE/risk stay keyed
                    # on the (type, zone, ct) pool the coordinate draws from
                    slice_pod=o.slice_pod,
                    slice_coord=o.slice_coord,
                )
                for o in it.offerings
            ]
            out.append(it.with_offerings(offerings))
        self._it_cache[pname] = (key, out)
        return out

    def is_machine_drifted(self, machine: Machine) -> bool:
        """Drift = the machine's launch personality is no longer what its
        NodeTemplate resolves to (isAMIDrifted + launch-template hash drift,
        cloudprovider.go:207-236): per-(family, variant) image comparison for
        template-launched machines, plus a full launch-config re-resolution —
        a userdata/block-device/SG change produces a new content-hash name.
        Machines launched without a template fall back to the single default
        image pointer."""
        instance = self.instances.get(_instance_id(machine.status.provider_id))
        if instance is None:
            return False
        if not instance.launch_template:
            return instance.image_id != self.current_images.get("default", "image-001")
        expected_img = self.current_images.get(
            f"{instance.image_family}/{instance.image_variant}"
        )
        if expected_img is not None and instance.image_id != expected_img:
            return True
        if self.node_template_lookup is not None and machine.node_template_ref:
            nt = self.node_template_lookup(machine.node_template_ref)
            it = self._by_name.get(instance.instance_type)
            if nt is not None and it is not None:
                # read-only resolution: a drift poll must not create or
                # TTL-refresh provider-side templates
                names = self.launch_template_provider.resolve_names(
                    nt,
                    [it],
                    taints=tuple(machine.taints),
                    labels=_bootstrap_labels(machine.meta.labels),
                    kubelet=machine.kubelet,
                )
                if names and instance.launch_template not in names:
                    return True
        return False

    def instance_for(self, machine: Machine) -> Optional[Instance]:
        return self.instances.get(_instance_id(machine.status.provider_id))

    def _instance_to_machine(self, instance: Instance) -> Machine:
        it = self._by_name[instance.instance_type]
        from ..api.objects import ObjectMeta

        m = Machine(
            meta=ObjectMeta(
                name=instance.id,
                creation_timestamp=instance.created,  # GC's too-young guard
                labels={
                    **it.requirements.labels(),
                    wk.INSTANCE_TYPE: instance.instance_type,
                    wk.ZONE: instance.zone,
                    wk.CAPACITY_TYPE: instance.capacity_type,
                    wk.PROVISIONER_NAME: instance.tags.get(wk.PROVISIONER_NAME, ""),
                    # slice identity survives describe/list reconstruction
                    # (GC re-adoption must not strip a node's coordinates)
                    **{
                        k: instance.tags[k]
                        for k in (wk.SLICE_POD, wk.SLICE_COORD)
                        if k in instance.tags
                    },
                },
            ),
            provisioner_name=instance.tags.get(wk.PROVISIONER_NAME, ""),
        )
        m.status = MachineStatus(
            provider_id=f"fake:///{instance.zone}/{instance.id}",
            capacity=it.capacity,
            allocatable=it.allocatable(),
            launched=True,
        )
        return m


def _instance_id(provider_id: str) -> str:
    return provider_id.rsplit("/", 1)[-1]


def _fleet_hash(machine: Machine) -> tuple:
    """Launch-shape bucket key: machines that could ride one CreateFleet call
    (same provisioner, template, and requirement surface — the reference
    hashes the CreateFleetInput, createfleet.go:97-110)."""
    reqs = tuple(
        sorted(
            (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
            for r in machine.requirements
        )
    )
    return (machine.provisioner_name, machine.node_template_ref, reqs)


def _bootstrap_labels(labels: Dict[str, str]) -> Dict[str, str]:
    """User-facing labels for bootstrap userdata: well-known/stamped domains
    (kubernetes.io and any karpenter domain, including instance.karpenter.*)
    excluded so the launch-config content hash is stable across the
    launch-time (pre-stamp) and drift-time (post-stamp) label surfaces."""
    out = {}
    for k, v in labels.items():
        domain = k.split("/", 1)[0] if "/" in k else ""
        if domain == "kubernetes.io" or domain.endswith(".kubernetes.io"):
            continue
        if "karpenter" in domain:
            continue
        out[k] = v
    return out


from .inventory import tags_match as _tags_match  # shared selector semantics
