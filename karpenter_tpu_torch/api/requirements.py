"""Node-selector requirement set-algebra.

This is the TPU-native rebuild of karpenter-core's ``scheduling.Requirements``
library — the dependency of the scheduler, the cloud-provider instance-type filter
(upstream ``pkg/cloudprovider/cloudprovider.go:254-273``) and the instance-type
label surface (upstream ``pkg/providers/instancetype/types.go:67-122``).

A ``Requirement`` models the allowed value-set for one label key as either a finite
set (``In``) or the complement of a finite set (``NotIn`` / ``Exists``), plus optional
integer bounds (``Gt`` / ``Lt``). ``Requirements`` is a keyed collection supporting
``intersect`` and ``compatible``.

Compatibility semantics follow the reference: for every key the incoming set
constrains, the receiver must either define the key with a non-empty intersection, or
not define it at all *and* the incoming operator must tolerate absence
(``NotIn`` / ``DoesNotExist``).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

# Operators (kubernetes NodeSelectorOperator names).
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_NEG_INF = float("-inf")
_POS_INF = float("inf")


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


class Requirement:
    """Allowed values for one label key.

    Internal form: ``(complement, values, greater_than, less_than)``.
      * complement=False: allowed = values (filtered by bounds)
      * complement=True:  allowed = everything except values (and within bounds)
    Bounds are exclusive, matching Gt/Lt.
    """

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        complement: bool,
        values: FrozenSet[str] = frozenset(),
        greater_than: float = _NEG_INF,
        less_than: float = _POS_INF,
    ):
        self.key = key
        self.complement = complement
        self.greater_than = greater_than
        self.less_than = less_than
        if not complement and (greater_than != _NEG_INF or less_than != _POS_INF):
            values = frozenset(
                v for v in values if _is_int(v) and greater_than < int(v) < less_than
            )
        self.values = values

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_operator(key: str, operator: str, values: Sequence[str] = ()) -> "Requirement":
        values = [str(v) for v in values]
        if operator == IN:
            return Requirement(key, complement=False, values=frozenset(values))
        if operator == NOT_IN:
            return Requirement(key, complement=True, values=frozenset(values))
        if operator == EXISTS:
            if values:
                raise ValueError(f"{key}: Exists takes no values")
            return Requirement(key, complement=True)
        if operator == DOES_NOT_EXIST:
            if values:
                raise ValueError(f"{key}: DoesNotExist takes no values")
            return Requirement(key, complement=False)
        if operator == GT:
            if len(values) != 1 or not _is_int(values[0]):
                raise ValueError(f"{key}: Gt takes exactly one integer value")
            return Requirement(key, complement=True, greater_than=float(int(values[0])))
        if operator == LT:
            if len(values) != 1 or not _is_int(values[0]):
                raise ValueError(f"{key}: Lt takes exactly one integer value")
            return Requirement(key, complement=True, less_than=float(int(values[0])))
        raise ValueError(f"unknown operator {operator!r}")

    @staticmethod
    def in_values(key: str, values: Iterable[str]) -> "Requirement":
        return Requirement(key, complement=False, values=frozenset(str(v) for v in values))

    @staticmethod
    def exists(key: str) -> "Requirement":
        return Requirement(key, complement=True)

    # -- predicates --------------------------------------------------------
    def _bounds_allow(self, value: str) -> bool:
        if self.greater_than == _NEG_INF and self.less_than == _POS_INF:
            return True
        return _is_int(value) and self.greater_than < int(value) < self.less_than

    def has(self, value: str) -> bool:
        value = str(value)
        if not self._bounds_allow(value):
            return False
        return (value not in self.values) if self.complement else (value in self.values)

    def tolerates_absence(self) -> bool:
        """True for operators satisfied by the label being absent (NotIn/DoesNotExist).

        Mirrors the operator check in core's Requirements.Compatible."""
        # DoesNotExist: empty non-complement set. NotIn: complement with no bounds.
        if not self.complement:
            return not self.values and self.greater_than == _NEG_INF and self.less_than == _POS_INF
        return bool(self.values) and self.greater_than == _NEG_INF and self.less_than == _POS_INF

    def is_empty(self) -> bool:
        if not self.complement:
            return not self.values
        # Complement sets are infinite over arbitrary strings unless integer bounds
        # shrink them to a finite (possibly empty) integer range.
        if self.greater_than == _NEG_INF or self.less_than == _POS_INF:
            return False
        lo, hi = int(self.greater_than) + 1, int(self.less_than) - 1
        if lo > hi:
            return True
        if (hi - lo + 1) <= len(self.values) + 1:
            return all(str(v) in self.values for v in range(lo, hi + 1))
        return False

    def any_value(self) -> Optional[str]:
        if not self.complement:
            return min(self.values) if self.values else None
        lo = int(self.greater_than) + 1 if self.greater_than != _NEG_INF else 0
        hi = int(self.less_than) - 1 if self.less_than != _POS_INF else lo + len(self.values) + 1
        for v in range(lo, hi + 1):
            if str(v) not in self.values:
                return str(v)
        return None

    def single_value(self) -> Optional[str]:
        if not self.complement and len(self.values) == 1:
            return next(iter(self.values))
        return None

    # -- algebra -----------------------------------------------------------
    def intersect(self, other: "Requirement") -> "Requirement":
        gt = max(self.greater_than, other.greater_than)
        lt = min(self.less_than, other.less_than)
        if self.complement and other.complement:
            return Requirement(self.key, True, self.values | other.values, gt, lt)
        if not self.complement and not other.complement:
            return Requirement(self.key, False, self.values & other.values, gt, lt)
        fin, comp = (self, other) if not self.complement else (other, self)
        return Requirement(self.key, False, fin.values - comp.values, gt, lt)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Requirement)
            and (self.key, self.complement, self.values, self.greater_than, self.less_than)
            == (other.key, other.complement, other.values, other.greater_than, other.less_than)
        )

    def __hash__(self) -> int:
        return hash((self.key, self.complement, self.values, self.greater_than, self.less_than))

    def __repr__(self) -> str:
        if self.complement:
            base = f"NotIn{sorted(self.values)}" if self.values else "Exists"
        else:
            base = f"In{sorted(self.values)}" if self.values else "DoesNotExist"
        bounds = ""
        if self.greater_than != _NEG_INF:
            bounds += f" >{int(self.greater_than)}"
        if self.less_than != _POS_INF:
            bounds += f" <{int(self.less_than)}"
        return f"Requirement({self.key} {base}{bounds})"


class Requirements:
    """A keyed set of Requirements with intersection / compatibility checks."""

    __slots__ = ("_by_key",)

    def __init__(self, requirements: Iterable[Requirement] = ()):
        by_key: Dict[str, Requirement] = {}
        for r in requirements:
            by_key[r.key] = by_key[r.key].intersect(r) if r.key in by_key else r
        self._by_key = by_key

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_labels(labels: Mapping[str, str]) -> "Requirements":
        return Requirements(Requirement.in_values(k, [v]) for k, v in labels.items())

    @staticmethod
    def from_node_selector_terms(terms: Sequence[Mapping]) -> List["Requirements"]:
        """Each term is OR'd; within a term, matchExpressions are AND'd."""
        out = []
        for term in terms:
            reqs = [
                Requirement.from_operator(e["key"], e["operator"], e.get("values", ()))
                for e in term.get("matchExpressions", ())
            ]
            out.append(Requirements(reqs))
        return out

    # -- accessors ---------------------------------------------------------
    def keys(self) -> Iterable[str]:
        return self._by_key.keys()

    def has(self, key: str) -> bool:
        return key in self._by_key

    def get(self, key: str) -> Requirement:
        """Requirement for key; absent keys default to Exists (anything allowed)."""
        return self._by_key.get(key) or Requirement.exists(key)

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._by_key.values())

    def __len__(self) -> int:
        return len(self._by_key)

    # -- algebra -----------------------------------------------------------
    def intersect(self, other: "Requirements") -> "Requirements":
        return Requirements(list(self._by_key.values()) + list(other._by_key.values()))

    def add(self, *reqs: Requirement) -> "Requirements":
        return Requirements(list(self._by_key.values()) + list(reqs))

    def compatible(self, other: "Requirements") -> bool:
        """True if a value assignment satisfying ``other`` can satisfy ``self``.

        For every key in ``other``: if we define the key, the intersection must be
        non-empty; if we don't, the incoming operator must tolerate absence. Mirrors
        core's Requirements.Compatible (call sites at
        upstream pkg/cloudprovider/cloudprovider.go:267).
        """
        for key, theirs in other._by_key.items():
            ours = self._by_key.get(key)
            if ours is None:
                if not theirs.tolerates_absence():
                    return False
                continue
            if ours.intersect(theirs).is_empty():
                return False
        return True

    def is_empty_any(self) -> bool:
        return any(r.is_empty() for r in self._by_key.values())

    def labels(self) -> Dict[str, str]:
        """Concrete labels derivable from single-value In requirements."""
        out = {}
        for key, r in self._by_key.items():
            v = r.single_value()
            if v is not None:
                out[key] = v
        return out

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Requirements) and self._by_key == other._by_key

    def __repr__(self) -> str:
        return f"Requirements({list(self._by_key.values())!r})"


EMPTY = Requirements()
