"""Image-family strategies + resolver: node OS personality at launch time.

Rebuild of the reference's AMI-family layer
(upstream ``pkg/providers/amifamily/resolver.go:72-141``, ``al2.go``,
``bottlerocket.go``, ``ubuntu.go``, ``custom.go``, and the bootstrap package
``pkg/providers/amifamily/bootstrap`` — 519 LoC of userdata generation):

* Each family is a strategy object: how to discover its default images, how to
  render bootstrap user data (shell + MIME-multipart merge for AL2/Ubuntu,
  structured TOML merge for Bottlerocket, verbatim passthrough for Custom),
  default block devices, and the ephemeral device name.
* The resolver groups instance types by the image they resolve to — accelerator
  (GPU/TPU) instance types get the accelerator image variant, everything else
  the standard one (``resolver.go:108-141`` groups GPU vs CPU AMIs) — and
  selects the newest image by creation date (``ami.go:236-245``).

Nothing here is a translation: the reference renders EKS/EC2-specific payloads;
this renders the equivalent cloud-neutral bootstrap configs for the fake
backend, with the same structure (kubelet args, taints, labels, CA bundle,
custom-data merging) so the behavioral surface matches.
"""

from __future__ import annotations

import abc
import email.mime.multipart
import email.mime.text
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.objects import BlockDeviceMapping, KubeletConfiguration, NodeTemplate, Taint
from ..api.resources import GPU_NVIDIA, GPU_TPU, Resources

ACCELERATOR_RESOURCES = ("tpu", "gpu", GPU_TPU, GPU_NVIDIA, "accelerator")


@dataclass
class ClusterInfo:
    name: str = "karpenter-tpu"
    endpoint: str = "https://cluster.local"
    ca_bundle: Optional[str] = None
    dns_ip: Optional[str] = None


@dataclass
class BootstrapContext:
    cluster: ClusterInfo
    kubelet: Optional[KubeletConfiguration] = None
    taints: Sequence[Taint] = ()
    labels: Dict[str, str] = field(default_factory=dict)
    custom_user_data: Optional[str] = None


class ImageFamily(abc.ABC):
    """Strategy surface per OS family (reference AMIFamily interface,
    resolver.go:72-79)."""

    name: str = ""

    @abc.abstractmethod
    def user_data(self, ctx: BootstrapContext) -> str: ...

    def image_variants(self) -> Tuple[str, ...]:
        return ("standard", "accelerator")

    def default_block_devices(self) -> List[BlockDeviceMapping]:
        return [BlockDeviceMapping(device_name="/dev/xvda", volume_size_gib=20)]

    def ephemeral_device(self) -> Optional[str]:
        return "/dev/xvdb"

    # -- shared helpers ----------------------------------------------------
    def _kubelet_args(self, ctx: BootstrapContext) -> List[str]:
        args = []
        if ctx.labels:
            args.append(
                "--node-labels=" + ",".join(f"{k}={v}" for k, v in sorted(ctx.labels.items()))
            )
        if ctx.taints:
            args.append(
                "--register-with-taints="
                + ",".join(f"{t.key}={t.value}:{t.effect}" for t in ctx.taints)
            )
        kc = ctx.kubelet
        if kc is not None:
            if kc.max_pods is not None:
                args.append(f"--max-pods={kc.max_pods}")
            if kc.pods_per_core is not None:
                args.append(f"--pods-per-core={kc.pods_per_core}")
            if kc.cluster_dns:
                args.append("--cluster-dns=" + ",".join(kc.cluster_dns))
        return args


class ShellBootstrapFamily(ImageFamily):
    """Shell-script bootstrap with MIME-multipart custom-userdata merge — the
    AL2/Ubuntu shape (reference eksbootstrap.go): the custom part rides first,
    the bootstrap invocation last, so user units run before kubelet start."""

    bootstrap_path = "/etc/node/bootstrap.sh"

    def user_data(self, ctx: BootstrapContext) -> str:
        script_lines = [
            "#!/bin/bash -xe",
            f"exec > >(tee /var/log/node-bootstrap.log) 2>&1",
            f"{self.bootstrap_path} '{ctx.cluster.name}' \\",
            f"  --apiserver-endpoint '{ctx.cluster.endpoint}' \\",
        ]
        if ctx.cluster.ca_bundle:
            script_lines.append(f"  --b64-cluster-ca '{ctx.cluster.ca_bundle}' \\")
        if ctx.cluster.dns_ip:
            script_lines.append(f"  --dns-cluster-ip '{ctx.cluster.dns_ip}' \\")
        kubelet_args = self._kubelet_args(ctx)
        script_lines.append("  --kubelet-extra-args '" + " ".join(kubelet_args) + "'")
        script = "\n".join(script_lines) + "\n"
        if not ctx.custom_user_data:
            return script
        # MIME multipart merge: custom part first, bootstrap last
        outer = email.mime.multipart.MIMEMultipart(
            "mixed", boundary="//KARPENTER-TPU-BOUNDARY//"
        )
        for payload in (ctx.custom_user_data, script):
            part = email.mime.text.MIMEText(payload, "x-shellscript", "us-ascii")
            outer.attach(part)
        return outer.as_string()


class AL2Family(ShellBootstrapFamily):
    name = "al2"


class UbuntuFamily(ShellBootstrapFamily):
    name = "ubuntu"
    bootstrap_path = "/etc/node/ubuntu-bootstrap.sh"

    def default_block_devices(self) -> List[BlockDeviceMapping]:
        return [BlockDeviceMapping(device_name="/dev/sda1", volume_size_gib=20)]


class BottlerocketFamily(ImageFamily):
    """Structured-config family: user data is a TOML settings document, merged
    key-by-key with the operator-provided TOML (reference bottlerocket.go +
    bottlerocketsettings.go — user keys win only where they don't collide with
    cluster-critical settings)."""

    name = "bottlerocket"

    def user_data(self, ctx: BootstrapContext) -> str:
        settings: Dict[str, Dict] = {}
        if ctx.custom_user_data:
            from .. import _toml

            try:
                settings = _toml.loads(ctx.custom_user_data)
            except Exception:
                settings = {}
        k8s = settings.setdefault("settings", {}).setdefault("kubernetes", {})
        # cluster-critical settings always win over user data
        k8s["cluster-name"] = ctx.cluster.name
        k8s["api-server"] = ctx.cluster.endpoint
        if ctx.cluster.ca_bundle:
            k8s["cluster-certificate"] = ctx.cluster.ca_bundle
        if ctx.cluster.dns_ip:
            k8s["cluster-dns-ip"] = ctx.cluster.dns_ip
        if ctx.labels:
            k8s.setdefault("node-labels", {}).update(
                {k: str(v) for k, v in sorted(ctx.labels.items())}
            )
        if ctx.taints:
            k8s.setdefault("node-taints", {}).update(
                {t.key: f"{t.value}:{t.effect}" for t in ctx.taints}
            )
        kc = ctx.kubelet
        if kc is not None and kc.max_pods is not None:
            k8s["max-pods"] = kc.max_pods
        return _toml_dumps(settings)

    def default_block_devices(self) -> List[BlockDeviceMapping]:
        # OS volume + data volume, the bottlerocket two-volume layout
        return [
            BlockDeviceMapping(device_name="/dev/xvda", volume_size_gib=4),
            BlockDeviceMapping(device_name="/dev/xvdb", volume_size_gib=20),
        ]


class CustomFamily(ImageFamily):
    """Verbatim passthrough: the operator owns the full userdata (custom.go)."""

    name = "custom"

    def user_data(self, ctx: BootstrapContext) -> str:
        return ctx.custom_user_data or ""

    def default_block_devices(self) -> List[BlockDeviceMapping]:
        return []


FAMILIES: Dict[str, ImageFamily] = {
    f.name: f for f in (AL2Family(), UbuntuFamily(), BottlerocketFamily(), CustomFamily())
}
DEFAULT_FAMILY = "al2"


def get_family(name: Optional[str]) -> ImageFamily:
    if not name or name == "default":
        return FAMILIES[DEFAULT_FAMILY]
    fam = FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown image family {name!r}; known: {sorted(FAMILIES)}")
    return fam


def _toml_dumps(d: Dict, prefix: str = "") -> str:
    """Minimal nested-table TOML writer (tomllib is read-only)."""
    lines: List[str] = []
    scalars = {k: v for k, v in d.items() if not isinstance(v, dict)}
    tables = {k: v for k, v in d.items() if isinstance(v, dict)}
    for k, v in scalars.items():
        if isinstance(v, bool):
            sv = "true" if v else "false"
        elif isinstance(v, (int, float)):
            sv = str(v)
        else:
            sv = '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'
        lines.append(f"{_toml_key(k)} = {sv}")
    for k, v in tables.items():
        path = f"{prefix}.{_toml_key(k)}" if prefix else _toml_key(k)
        body = _toml_dumps(v, path)
        lines.append(f"[{path}]")
        if body:
            lines.append(body)
    return "\n".join(lines)


def _toml_key(k: str) -> str:
    if all(c.isalnum() or c in "-_" for c in k):
        return k
    return '"' + k.replace('"', '\\"') + '"'


# ---------------------------------------------------------------------------
# Resolver: instance types -> (image, userdata) launch groups
# ---------------------------------------------------------------------------

@dataclass
class ResolvedSpec:
    """One launch-config worth of resolution: every instance type in the group
    boots the same image with the same bootstrap payload."""

    family: str
    variant: str  # standard | accelerator
    image_id: str
    user_data: str
    block_devices: List[BlockDeviceMapping]
    instance_type_names: List[str]


def is_accelerator(capacity: Resources) -> bool:
    return any(capacity.get(r) > 0 for r in ACCELERATOR_RESOURCES)


class ImageResolver:
    """Groups instance types by resolved image per family/variant and renders
    the bootstrap payload (Resolver.Resolve, resolver.go:108-141)."""

    def __init__(self, image_source):
        # image_source: object with .list_images(family) -> [Image(id, family,
        # created, tags)]; tags may carry {"variant": "accelerator"}
        self.image_source = image_source

    def resolve_image(self, node_template: NodeTemplate, variant: str) -> Optional[str]:
        family = get_family(node_template.image_family)
        images = self.image_source.list_images(family.name)
        if node_template.image_selector:
            images = [
                i
                for i in images
                if all(i.tags.get(k) == v for k, v in node_template.image_selector.items())
            ]
        want_variant = variant if variant in family.image_variants() else "standard"
        matching = [i for i in images if i.tags.get("variant", "standard") == want_variant]
        if not matching and want_variant != "standard":
            matching = [i for i in images if i.tags.get("variant", "standard") == "standard"]
        if not matching:
            return None
        # newest by creation date (ami.go:236-245)
        return max(matching, key=lambda i: i.created).id

    def resolve(
        self,
        node_template: NodeTemplate,
        instance_types: Sequence,
        ctx: BootstrapContext,
    ) -> List[ResolvedSpec]:
        family = get_family(node_template.image_family)
        groups: Dict[str, List[str]] = {}
        for it in instance_types:
            variant = "accelerator" if is_accelerator(it.capacity) else "standard"
            groups.setdefault(variant, []).append(it.name)
        user_data = family.user_data(
            BootstrapContext(
                cluster=ctx.cluster,
                kubelet=ctx.kubelet,
                taints=ctx.taints,
                labels=ctx.labels,
                custom_user_data=node_template.user_data,
            )
        )
        block_devices = (
            list(node_template.block_device_mappings)
            if node_template.block_device_mappings
            else family.default_block_devices()
        )
        specs: List[ResolvedSpec] = []
        for variant, names in sorted(groups.items()):
            image = self.resolve_image(node_template, variant)
            if image is None:
                continue
            specs.append(
                ResolvedSpec(
                    family=family.name,
                    variant=variant,
                    image_id=image,
                    user_data=user_data,
                    block_devices=block_devices,
                    instance_type_names=sorted(names),
                )
            )
        return specs
