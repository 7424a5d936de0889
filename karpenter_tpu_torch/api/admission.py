"""Admission layer: defaulting + validation at object write time.

Rebuild of the reference's webhook surface
(upstream ``pkg/webhooks/webhooks.go:34-63`` registers defaulting and
validation admission webhooks; field rules live in
``pkg/apis/v1alpha1/provider_validation.go`` and karpenter-core's
``provisioner_validation.go``). There is no apiserver here, so the cluster
store invokes these at ``add_provisioner``/``add_node_template`` — the same
chokepoint an admission webhook occupies: nothing invalid is ever visible to
a controller.
"""

from __future__ import annotations

from typing import List, Optional

from . import labels as wk
from .objects import NodeTemplate, Provisioner, Taint

VALID_CAPACITY_TYPES = {wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND}
VALID_TAINT_EFFECTS = {"NoSchedule", "PreferNoSchedule", "NoExecute"}
MAX_WEIGHT = 100


class AdmissionError(ValueError):
    """Rejected by the admission layer; ``field_errors`` lists every failure
    (webhooks report the full error set, not just the first)."""

    def __init__(self, kind: str, name: str, field_errors: List[str]):
        self.kind = kind
        self.name = name
        self.field_errors = list(field_errors)
        super().__init__(
            f"{kind}/{name} rejected: " + "; ".join(self.field_errors)
        )


# -- defaulting (the mutating webhook) --------------------------------------

def _defaulted_taints(taints: List[Taint]) -> List[Taint]:
    return [
        t if t.effect else Taint(key=t.key, value=t.value, effect="NoSchedule")
        for t in taints
    ]


def default_provisioner(p: Provisioner) -> Provisioner:
    """Defaulting, idempotent (SetDefaults in the reference). Taints are
    frozen values, so empty effects default by replacement."""
    if p.weight is None:
        p.weight = 0
    p.taints = _defaulted_taints(p.taints)
    p.startup_taints = _defaulted_taints(p.startup_taints)
    return p


def default_node_template(nt: NodeTemplate) -> NodeTemplate:
    if not nt.image_family:
        nt.image_family = "default"
    return nt


# -- validation (the validating webhook) ------------------------------------

def _validate_taints(taints: List[Taint], field: str, errs: List[str]) -> None:
    seen = set()
    for t in taints:
        if not t.key:
            errs.append(f"{field}: taint key must not be empty")
        if t.effect and t.effect not in VALID_TAINT_EFFECTS:
            errs.append(f"{field}: invalid taint effect {t.effect!r}")
        key = (t.key, t.effect)
        if key in seen:
            errs.append(f"{field}: duplicate taint {t.key}:{t.effect}")
        seen.add(key)


def validate_provisioner(p: Provisioner) -> None:
    errs: List[str] = []
    if not p.meta.name:
        errs.append("metadata.name must not be empty")
    if p.weight < 0 or p.weight > MAX_WEIGHT:
        errs.append(f"spec.weight must be in [0, {MAX_WEIGHT}], got {p.weight}")
    for field_name, ttl in (
        ("ttlSecondsAfterEmpty", p.ttl_seconds_after_empty),
        ("ttlSecondsUntilExpired", p.ttl_seconds_until_expired),
    ):
        if ttl is not None and ttl < 0:
            errs.append(f"spec.{field_name} must be non-negative, got {ttl}")
    if p.consolidation_enabled and p.ttl_seconds_after_empty is not None:
        errs.append(
            "spec.consolidation.enabled and spec.ttlSecondsAfterEmpty are mutually exclusive"
        )
    for key in p.requirements.keys():
        if key in wk.RESTRICTED_LABELS:
            errs.append(f"spec.requirements: restricted label {key}")
    ct = p.requirements.get(wk.CAPACITY_TYPE)
    for v in getattr(ct, "values", ()) or ():
        if v not in VALID_CAPACITY_TYPES:
            errs.append(f"spec.requirements: unknown capacity type {v!r}")
    for k in p.labels:
        if k in wk.RESTRICTED_LABELS:
            errs.append(f"spec.labels: restricted label {k}")
    _validate_taints(p.taints, "spec.taints", errs)
    _validate_taints(p.startup_taints, "spec.startupTaints", errs)
    if p.limits is not None:
        for axis, amount in p.limits.items():
            if amount < 0:
                errs.append(f"spec.limits.{axis} must be non-negative")
    if errs:
        raise AdmissionError("Provisioner", p.meta.name or "<unnamed>", errs)


#: the image families ``cloudprovider/imagefamily.py`` defines (its
#: ``FAMILIES`` keys); the port has no image resolver yet, so admission
#: keeps the names alone
FAMILIES = ("al2", "bottlerocket", "custom", "ubuntu")


def validate_node_template(nt: NodeTemplate) -> None:
    errs: List[str] = []
    if not nt.meta.name:
        errs.append("metadata.name must not be empty")
    if nt.image_family and nt.image_family != "default":
        if nt.image_family not in FAMILIES:
            errs.append(
                f"spec.imageFamily: unknown family {nt.image_family!r}"
                f" (known: {sorted(FAMILIES)})"
            )
    for sel_name, sel in (
        ("subnetSelector", nt.subnet_selector),
        ("securityGroupSelector", nt.security_group_selector),
        ("imageSelector", nt.image_selector),
    ):
        for k, v in sel.items():
            if not k:
                errs.append(f"spec.{sel_name}: empty selector key")
            if v is None:
                errs.append(f"spec.{sel_name}[{k}]: selector value must not be null")
    for i, bdm in enumerate(nt.block_device_mappings):
        if not bdm.device_name:
            errs.append(f"spec.blockDeviceMappings[{i}].deviceName must not be empty")
        if bdm.volume_size_gib is not None and bdm.volume_size_gib <= 0:
            errs.append(
                f"spec.blockDeviceMappings[{i}].volumeSize must be positive,"
                f" got {bdm.volume_size_gib}"
            )
    if nt.user_data is not None and nt.image_family == "bottlerocket":
        from .. import _toml

        try:
            _toml.loads(nt.user_data)
        except Exception as e:
            errs.append(f"spec.userData: bottlerocket userdata must be valid TOML ({e})")
    if errs:
        raise AdmissionError("NodeTemplate", nt.meta.name or "<unnamed>", errs)


def admit_provisioner(p: Provisioner) -> Provisioner:
    """Defaulting then validation — the full webhook chain."""
    default_provisioner(p)
    validate_provisioner(p)
    return p


def admit_node_template(nt: NodeTemplate) -> NodeTemplate:
    default_node_template(nt)
    validate_node_template(nt)
    return nt
