"""Taints and tolerations.

Semantics follow kubernetes core/v1 as exercised by the reference's scheduler
(taints on Provisioner spec, upstream ``pkg/apis/crds/karpenter.sh_provisioners.yaml``;
startup taints ignored for scheduling; see website concepts/scheduling.md "Taints and
tolerations").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Tuple

NO_SCHEDULE = "NoSchedule"
NO_EXECUTE = "NoExecute"
PREFER_NO_SCHEDULE = "PreferNoSchedule"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str = NO_SCHEDULE
    value: str = ""

    def as_tuple(self) -> Tuple[str, str, str]:
        return (self.key, self.value, self.effect)


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return not self.key or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates_all(
    tolerations: Sequence[Toleration], taints: Iterable[Taint], include_preferred: bool = False
) -> bool:
    """True if the toleration set tolerates every scheduling-relevant taint.

    PreferNoSchedule taints never block scheduling (soft), matching kube-scheduler.
    """
    for taint in taints:
        if taint.effect == PREFER_NO_SCHEDULE and not include_preferred:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return False
    return True
