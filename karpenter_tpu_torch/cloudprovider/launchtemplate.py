"""Launch-config (launch template) provider: resolved node personality, cached.

Rebuild of the reference's launch-template layer
(upstream ``pkg/providers/launchtemplate/launchtemplate.go:89-135``
EnsureAll, ``:273-304`` cache hydration + eviction): the resolver's
(image x userdata x block devices x security groups) output is materialized
into provider-side launch configs with CONTENT-HASH names, so

* identical node personalities dedupe to one config (``launchTemplateName``
  hashes the resolved options in the reference),
* a changed input (image rotation, new userdata) produces a NEW name — which
  is exactly what machine drift detection keys on, and
* configs are cached with a TTL whose eviction deletes the provider-side
  object (``launchtemplate.go:273-304``); the cache hydrates from the
  provider on startup so restarts don't leak or recreate configs.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.objects import KubeletConfiguration, NodeTemplate, Taint
from .imagefamily import (
    BootstrapContext,
    ClusterInfo,
    ImageResolver,
    ResolvedSpec,
)

NAME_PREFIX = "ktpu-lt-"
DEFAULT_TTL = 300.0


@dataclass(frozen=True)
class LaunchConfig:
    """One provider-side launch template: everything a node boots with."""

    name: str  # NAME_PREFIX + content hash
    family: str
    variant: str  # standard | accelerator
    image_id: str
    user_data: str
    block_devices: Tuple = ()
    security_group_ids: Tuple[str, ...] = ()
    instance_type_names: Tuple[str, ...] = ()
    metadata_options: Tuple = ()

    def covers(self, instance_type_name: str) -> bool:
        return instance_type_name in self.instance_type_names


def _content_name(spec: ResolvedSpec, security_group_ids: Sequence[str], metadata_options) -> str:
    payload = json.dumps(
        {
            "family": spec.family,
            "variant": spec.variant,
            "image": spec.image_id,
            "user_data": spec.user_data,
            "block_devices": [
                (b.device_name, b.volume_size_gib, getattr(b, "volume_type", None))
                for b in spec.block_devices
            ],
            "security_groups": sorted(security_group_ids),
            "metadata_options": sorted(metadata_options.items()) if metadata_options else [],
        },
        sort_keys=True,
    ).encode()
    return NAME_PREFIX + hashlib.sha256(payload).hexdigest()[:16]


class LaunchTemplateProvider:
    """EnsureAll + content-hash cache over an ImageResolver.

    ``store`` is the provider-side template store — any object with
    ``create_launch_template(config)``, ``delete_launch_template(name)`` and
    ``list_launch_templates()`` (the fake provider implements these; a real
    backend would call its cloud API).
    """

    def __init__(
        self,
        store,
        resolver: ImageResolver,
        cluster: Optional[ClusterInfo] = None,
        ttl: float = DEFAULT_TTL,
        clock: Optional[Callable[[], float]] = None,
    ):
        import time as _time

        self.store = store
        self.resolver = resolver
        self.cluster = cluster or ClusterInfo()
        self.ttl = ttl
        self._clock = clock or _time.monotonic
        self._lock = threading.Lock()
        self._cache: Dict[str, Tuple[float, LaunchConfig]] = {}  # name -> (expiry, cfg)
        self._hydrated = False

    # -- cache maintenance --------------------------------------------------
    def _hydrate(self) -> None:
        """Adopt provider-side configs left by a previous process so we reuse
        rather than leak/recreate them (launchtemplate.go:273-304)."""
        if self._hydrated:
            return
        self._hydrated = True
        now = self._clock()
        for cfg in self.store.list_launch_templates():
            if cfg.name.startswith(NAME_PREFIX):
                self._cache.setdefault(cfg.name, (now + self.ttl, cfg))

    def _evict_expired(self) -> None:
        now = self._clock()
        for name in [n for n, (exp, _) in self._cache.items() if exp <= now]:
            del self._cache[name]
            try:
                self.store.delete_launch_template(name)
            except Exception:
                pass  # already gone provider-side; nothing to unwind

    # -- the EnsureAll surface ----------------------------------------------
    def ensure_all(
        self,
        node_template: NodeTemplate,
        instance_types: Sequence,
        taints: Sequence[Taint] = (),
        labels: Optional[Dict[str, str]] = None,
        kubelet: Optional[KubeletConfiguration] = None,
    ) -> List[LaunchConfig]:
        """Resolve (image family x variant) groups for these instance types and
        return one existing-or-created launch config per group
        (launchtemplate.go:89-135)."""
        ctx = BootstrapContext(
            cluster=self.cluster,
            kubelet=kubelet,
            taints=tuple(taints),
            labels=dict(labels or {}),
        )
        specs = self.resolver.resolve(node_template, instance_types, ctx)
        sgs = tuple(node_template.resolved_security_groups)
        out: List[LaunchConfig] = []
        with self._lock:
            self._hydrate()
            self._evict_expired()
            now = self._clock()
            for spec in specs:
                name = _content_name(spec, sgs, node_template.metadata_options)
                entry = self._cache.get(name)
                if entry is not None:
                    cfg = entry[1]
                    if set(spec.instance_type_names) - set(cfg.instance_type_names):
                        # same personality, wider type group: extend coverage
                        cfg = LaunchConfig(
                            **{
                                **cfg.__dict__,
                                "instance_type_names": tuple(
                                    sorted(
                                        set(cfg.instance_type_names)
                                        | set(spec.instance_type_names)
                                    )
                                ),
                            }
                        )
                        self.store.create_launch_template(cfg)
                    self._cache[name] = (now + self.ttl, cfg)  # touch
                    out.append(cfg)
                    continue
                cfg = LaunchConfig(
                    name=name,
                    family=spec.family,
                    variant=spec.variant,
                    image_id=spec.image_id,
                    user_data=spec.user_data,
                    block_devices=tuple(spec.block_devices),
                    security_group_ids=sgs,
                    instance_type_names=tuple(spec.instance_type_names),
                    metadata_options=tuple(sorted(node_template.metadata_options.items())),
                )
                self.store.create_launch_template(cfg)
                self._cache[name] = (now + self.ttl, cfg)
                out.append(cfg)
        return out

    def resolve_names(
        self,
        node_template: NodeTemplate,
        instance_types: Sequence,
        taints: Sequence[Taint] = (),
        labels: Optional[Dict[str, str]] = None,
        kubelet: Optional[KubeletConfiguration] = None,
    ) -> List[str]:
        """The content-hash names ensure_all WOULD produce, with no store
        writes or cache touches — the read-only form drift detection needs
        (a pure predicate must not create provider-side templates)."""
        ctx = BootstrapContext(
            cluster=self.cluster,
            kubelet=kubelet,
            taints=tuple(taints),
            labels=dict(labels or {}),
        )
        specs = self.resolver.resolve(node_template, instance_types, ctx)
        sgs = tuple(node_template.resolved_security_groups)
        return [
            _content_name(spec, sgs, node_template.metadata_options) for spec in specs
        ]

    def cached_names(self) -> List[str]:
        with self._lock:
            return sorted(self._cache)
