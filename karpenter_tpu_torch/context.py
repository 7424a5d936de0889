"""Operator context: discovery + dependency wiring.

Rebuild of the reference's provider context
(upstream ``pkg/context/context.go:60-166``): one constructor that
discovers the environment (region/IMDS, cluster endpoint, CA bundle, DNS IP),
verifies cloud connectivity (``checkEC2Connectivity`` ``:177``), builds every
provider, and hands controllers a fully-wired bundle. Here discovery reads
settings + probes the cloud provider fake; the connectivity check is a real
call that fails fast when the backend is broken.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .api.settings import Settings
from .cloudprovider.fake import FakeCloudProvider
from .cloudprovider.imagefamily import ClusterInfo
from .cloudprovider.interface import CloudProvider


class ConnectivityError(RuntimeError):
    pass


@dataclass
class OperatorContext:
    settings: Settings
    provider: CloudProvider
    cluster_info: ClusterInfo
    region: str = "region-1"

    @staticmethod
    def discover(
        provider: Optional[CloudProvider] = None,
        settings: Optional[Settings] = None,
    ) -> "OperatorContext":
        """Build the context: settings from env when not given, cluster
        identity from settings, region from the provider's zone inventory
        (the IMDS-region analogue), and a connectivity probe."""
        settings = settings or Settings.from_env()
        settings.validate()
        provider = provider or FakeCloudProvider()

        # connectivity check (context.go:177): a cheap real call
        try:
            types = provider.get_instance_types(None)
            if not types:
                raise ConnectivityError("cloud provider returned an empty catalog")
        except ConnectivityError:
            raise
        except Exception as e:  # pragma: no cover - defensive
            raise ConnectivityError(f"cloud provider unreachable: {e}") from e

        # region discovery: zones like "zone-a" belong to one region in the
        # fake; a real backend would ask IMDS
        zones = sorted({o.zone for it in types[:5] for o in it.offerings})
        region = zones[0].rsplit("-", 1)[0] if zones else "region-1"

        cluster_info = ClusterInfo(
            name=settings.cluster_name,
            endpoint=settings.cluster_endpoint or f"https://{settings.cluster_name}.local",
        )
        # propagate the discovered identity into launch-config rendering
        if isinstance(provider, FakeCloudProvider):
            provider.launch_template_provider.cluster = cluster_info
        return OperatorContext(
            settings=settings,
            provider=provider,
            cluster_info=cluster_info,
            region=region,
        )
