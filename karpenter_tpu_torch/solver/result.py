"""Solver request/result types shared by every backend."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as TSequence

from ..api.objects import Pod
from .encode import EncodedProblem, LaunchOption


class LazyNames(TSequence):
    """List-of-names view over a group's pod list, materialized on first
    access. Decoders build one per group instead of copying 50k name strings
    on the solve's critical path — the strings only exist if a consumer
    (binding, validation, tests) actually reads them."""

    __slots__ = ("_pods", "_names")

    def __init__(self, pods):
        self._pods = pods
        self._names: Optional[List[str]] = None

    def _materialize(self) -> List[str]:
        if self._names is None:
            self._names = [p.meta.name for p in self._pods]
        return self._names

    def __len__(self) -> int:
        return len(self._pods)

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __contains__(self, item) -> bool:
        return item in self._materialize()


class NameSlice(TSequence):
    """Lazy view over slices of per-group pod-name lists.

    The host decoder assigns contiguous runs of each group's (identical) pods to
    nodes; copying 50k name strings into per-node lists is pure overhead on the
    solve's critical path when most results are consolidation candidates that
    are never bound. This view holds (namelist, start, count) segments and
    materializes once, on first element access. len() never materializes.
    """

    __slots__ = ("_segments", "_names")

    def __init__(self, segments):
        self._segments = segments  # list of (namelist, start, count)
        self._names: Optional[List[str]] = None

    def _materialize(self) -> List[str]:
        if self._names is None:
            out: List[str] = []
            for namelist, start, count in self._segments:
                out.extend(namelist[start : start + count])
            self._names = out
        return self._names

    def __len__(self) -> int:
        if self._names is not None:
            return len(self._names)
        return sum(c for _, _, c in self._segments)

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __contains__(self, item) -> bool:
        return item in self._materialize()

    def __eq__(self, other) -> bool:
        if isinstance(other, NameSlice):
            return self._materialize() == other._materialize()
        if isinstance(other, list):
            return self._materialize() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"NameSlice({self._materialize()!r})"


@dataclass
class NewNodeSpec:
    """A node the solver decided to launch, with its pod placement."""

    option: LaunchOption
    pod_names: TSequence = field(default_factory=list)
    option_index: Optional[int] = None  # index into EncodedProblem.options, if known

    @property
    def instance_type_name(self) -> str:
        return self.option.instance_type.name

    @property
    def price(self) -> float:
        return self.option.price


@dataclass
class SolveResult:
    new_nodes: List[NewNodeSpec] = field(default_factory=list)
    # existing node name -> newly assigned pod names
    existing_assignments: Dict[str, List[str]] = field(default_factory=dict)
    unschedulable: List[str] = field(default_factory=list)
    cost: float = 0.0  # total hourly price of new nodes
    # mostly-numeric solve diagnostics; a few identity entries are strings
    # (``aot_bucket`` — the executable-cache bucket the kernel dispatched on)
    stats: Dict[str, object] = field(default_factory=dict)
    # hex sha256 of the (final) encoded problem this result decodes —
    # ``solver.problem_digest`` of the problem actually solved, stamped by
    # ``solve_pods``. The flight recorder captures it per round and the
    # offline replay harness (karpenter_tpu/replay.py) asserts byte equality
    # against the re-encoded capsule. Already computed for interning, so the
    # stamp is free.
    problem_digest: str = ""

    @property
    def scheduled_count(self) -> int:
        return sum(len(n.pod_names) for n in self.new_nodes) + sum(
            len(v) for v in self.existing_assignments.values()
        )
