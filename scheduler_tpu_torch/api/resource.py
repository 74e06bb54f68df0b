"""Dense resource vectors with the reference's comparison semantics.

Replaces the reference's ``Resource`` struct and its operator set
(``pkg/scheduler/api/resource_info.go:130-360``) with a numpy-backed vector so the
same quantities can be stacked straight into [N, R] snapshot tensors.  The epsilon
semantics (minMilliCPU=10 / minMemory=10MiB / minMilliScalar=10,
``resource_info.go:70-72,253-276``) are reproduced exactly — they decide resource
fit and therefore gang counts.

Dense-vs-map note: the reference distinguishes "no scalar map at all" (nil) from
"scalar present with value 0", and ``Resource.Less`` branches on map presence in a
way that is reachable on cpu/memory-only clusters (``resource_info.go:231-236``:
both maps nil → Less is false regardless of cpu/memory).  ResourceVec therefore
carries an explicit ``has_scalars`` flag mirroring map presence, propagated through
arithmetic exactly as the reference creates maps.  Only the sub-corner of
explicitly-zero map *entries* (absent here, zero there) is approximated: a zero
entry is treated as absent.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from scheduler_tpu_torch.api.vocab import CPU, MEMORY, DEFAULT_VOCAB, ResourceVocabulary
from scheduler_tpu_torch.apis.objects import RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS
from scheduler_tpu_torch.utils.assertions import assert_that


class ResourceVec:
    """A resource quantity vector over a ResourceVocabulary.

    Mutating operators (add/sub/multi/...) modify in place and return self, like
    the reference's pointer methods; use ``clone()`` first when needed.
    ``max_task_num`` mirrors ``Resource.MaxTaskNum`` — used only by the pod-count
    predicate, never by arithmetic (``resource_info.go:37-40``).
    """

    __slots__ = ("vocab", "_arr", "max_task_num", "has_scalars")

    def __init__(
        self,
        vocab: Optional[ResourceVocabulary] = None,
        arr: Optional[np.ndarray] = None,
        max_task_num: int = 0,
        has_scalars: Optional[bool] = None,
    ) -> None:
        self.vocab = vocab if vocab is not None else DEFAULT_VOCAB
        if arr is None:
            self._arr = np.zeros(self.vocab.size, dtype=np.float64)
            if has_scalars is None:
                has_scalars = False
        else:
            self._arr = np.asarray(arr, dtype=np.float64)
        self.max_task_num = max_task_num
        # Mirrors "ScalarResources != nil" in the reference; inferred from content
        # when not stated explicitly.
        if has_scalars is None:
            has_scalars = bool(np.any(self._arr[2:] != 0.0))
        self.has_scalars = has_scalars

    # -- construction -------------------------------------------------------

    @classmethod
    def empty(cls, vocab: Optional[ResourceVocabulary] = None) -> "ResourceVec":
        return cls(vocab)

    @classmethod
    def from_dict(
        cls, quantities: Dict[str, float], vocab: Optional[ResourceVocabulary] = None
    ) -> "ResourceVec":
        """Build from canonical-unit quantities (``NewResource`` equivalent).

        'pods' feeds max_task_num; unknown scalar names are registered on the fly.
        """
        r = cls(vocab)
        for name, quant in quantities.items():
            if name == RESOURCE_PODS:
                r.max_task_num += int(quant)
            else:
                r.add_scalar(name, float(quant))
        return r

    def clone(self) -> "ResourceVec":
        self._sync()
        return ResourceVec(self.vocab, self._arr.copy(), self.max_task_num, self.has_scalars)

    # -- dense access -------------------------------------------------------

    def _sync(self) -> None:
        """Pad the backing array if the vocabulary grew since creation."""
        if self._arr.shape[0] != self.vocab.size:
            arr = np.zeros(self.vocab.size, dtype=np.float64)
            arr[: self._arr.shape[0]] = self._arr
            self._arr = arr

    @property
    def array(self) -> np.ndarray:
        """The dense [R] array (shared storage; copy before mutating externally)."""
        self._sync()
        return self._arr

    @property
    def milli_cpu(self) -> float:
        return float(self._arr[CPU])

    @property
    def memory(self) -> float:
        return float(self._arr[MEMORY])

    def get(self, name: str) -> float:
        """Quantity for a resource name; 0 for unregistered scalars."""
        self._sync()  # view-backed subclasses re-slice here; base is a no-op
        if name == RESOURCE_CPU:
            return float(self._arr[CPU])
        if name == RESOURCE_MEMORY:
            return float(self._arr[MEMORY])
        if name not in self.vocab:
            return 0.0
        return float(self._arr[self.vocab.dim(name)])

    def set_scalar(self, name: str, quantity: float) -> None:
        dim = self.vocab.dim(name) if name in self.vocab else self.vocab.register(name)
        self._sync()
        self._arr[dim] = quantity
        if dim >= 2:
            self.has_scalars = True

    def add_scalar(self, name: str, quantity: float) -> None:
        dim = self.vocab.dim(name) if name in self.vocab else self.vocab.register(name)
        self._sync()
        self._arr[dim] += quantity
        if dim >= 2:
            self.has_scalars = True

    def resource_names(self) -> Tuple[str, ...]:
        """cpu, memory, plus every scalar with a nonzero entry (= "in the map")."""
        self._sync()
        names = [RESOURCE_CPU, RESOURCE_MEMORY]
        vocab_names = self.vocab.names
        for dim in range(2, self._arr.shape[0]):
            if self._arr[dim] != 0.0:
                names.append(vocab_names[dim])
        return tuple(names)

    def _pair(self, other: "ResourceVec") -> Tuple[np.ndarray, np.ndarray]:
        if other.vocab is not self.vocab:
            raise ValueError("ResourceVec vocabulary mismatch")
        self._sync()
        other._sync()
        return self._arr, other._arr

    # -- predicates ---------------------------------------------------------

    def is_empty(self) -> bool:
        """Every dimension below its epsilon (``IsEmpty``, resource_info.go:96-108)."""
        self._sync()
        return bool(np.all(self._arr < self.vocab.min_thresholds()))

    def is_zero(self, name: str) -> bool:
        """One dimension below its epsilon (``IsZero``, resource_info.go:111-127)."""
        if name not in self.vocab:
            return True
        self._sync()
        dim = self.vocab.dim(name)
        return bool(self._arr[dim] < self.vocab.min_thresholds()[dim])

    def less(self, other: "ResourceVec") -> bool:
        """Strict element-wise less (``Less``, resource_info.go:226-250).

        cpu and memory compare strictly with no epsilon.  The reference's
        map-presence branches are reproduced via ``has_scalars``: if self has no
        scalar map, the result is True iff other HAS one (both nil → false, a
        reachable quirk on cpu/memory-only clusters that e.g. disables request
        capping in proportion's water-filling); otherwise scalar dims participate
        where self is nonzero (the dense reading of "keys in self's map").
        """
        a, b = self._pair(other)
        if not (a[CPU] < b[CPU] and a[MEMORY] < b[MEMORY]):
            return False
        if not self.has_scalars:
            return other.has_scalars
        scal_a, scal_b = a[2:], b[2:]
        mask = scal_a != 0.0
        return bool(np.all(scal_a[mask] < scal_b[mask]))

    def less_equal(self, other: "ResourceVec") -> bool:
        """Epsilon-tolerant <= (``LessEqual``, resource_info.go:253-276).

        Per dim: self < other OR |other - self| < min_threshold.
        """
        a, b = self._pair(other)
        mins = self.vocab.min_thresholds()
        ok = (a < b) | (np.abs(b - a) < mins)
        return bool(np.all(ok))

    # -- arithmetic (in place, returns self) --------------------------------

    def add(self, other: "ResourceVec") -> "ResourceVec":
        a, b = self._pair(other)
        a += b
        self.has_scalars = self.has_scalars or other.has_scalars
        return self

    def sub(self, other: "ResourceVec") -> "ResourceVec":
        """Subtract, asserting sufficiency like ``Sub`` (resource_info.go:144-159)."""
        assert_that(
            other.less_equal(self),
            lambda: f"resource is not sufficient to do operation: <{self}> sub <{other}>",
        )
        a, b = self._pair(other)
        a -= b
        return self

    def multi(self, ratio: float) -> "ResourceVec":
        self._sync()
        self._arr *= ratio
        return self

    def set_max(self, other: "ResourceVec") -> "ResourceVec":
        """Element-wise max in place (``SetMaxResource``, resource_info.go:162-187)."""
        a, b = self._pair(other)
        np.maximum(a, b, out=a)
        self.has_scalars = self.has_scalars or other.has_scalars
        return self

    def fit_delta(self, request: "ResourceVec") -> "ResourceVec":
        """Subtract request+epsilon where request>0; negative dims mark shortfalls
        (``FitDelta``, resource_info.go:193-213)."""
        a, b = self._pair(request)
        mins = self.vocab.min_thresholds()
        pos = b > 0.0
        a[pos] -= b[pos] + mins[pos]
        self.has_scalars = self.has_scalars or request.has_scalars
        return self

    def diff(self, other: "ResourceVec") -> Tuple["ResourceVec", "ResourceVec"]:
        """(increased, decreased) element-wise deltas (``Diff``, resource_info.go:279-311)."""
        a, b = self._pair(other)
        d = a - b
        inc = ResourceVec(self.vocab, np.where(d > 0, d, 0.0))
        dec = ResourceVec(self.vocab, np.where(d < 0, -d, 0.0))
        return inc, dec

    # -- batch-commit helpers ------------------------------------------------

    def add_array(self, arr: np.ndarray, has_scalars: bool = False) -> "ResourceVec":
        """Add a dense [R] delta in place (bulk-commit fast path: one numpy op
        stands in for many ``add`` calls)."""
        self._sync()
        self._arr += arr
        # Scalar-presence probe only when scalar dims EXIST: the common
        # cpu/memory-only vocab otherwise pays a numpy reduction over an
        # empty slice per call (~3us x thousands of bulk-commit calls).
        self.has_scalars = (
            self.has_scalars
            or has_scalars
            or (arr.shape[0] > 2 and bool(np.any(arr[2:] != 0.0)))
        )
        return self

    def sub_array(self, arr: np.ndarray) -> "ResourceVec":
        """Subtract a dense [R] delta in place, asserting epsilon-tolerant
        sufficiency like ``sub``."""
        self._sync()
        mins = self.vocab.min_thresholds()
        assert_that(
            bool(np.all((arr < self._arr) | (np.abs(self._arr - arr) < mins))),
            lambda: f"resource is not sufficient to do operation: <{self}> sub <{arr}>",
        )
        self._arr -= arr
        return self

    # -- misc ---------------------------------------------------------------

    def to_dict(self) -> Dict[str, float]:
        self._sync()
        out = {}
        for name, val in zip(self.vocab.names, self._arr):
            if val != 0.0 or name in (RESOURCE_CPU, RESOURCE_MEMORY):
                out[name] = float(val)
        if self.max_task_num:
            out[RESOURCE_PODS] = float(self.max_task_num)
        return out

    def __iter__(self) -> Iterator[Tuple[str, float]]:
        self._sync()
        return iter(zip(self.vocab.names, (float(v) for v in self._arr)))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ResourceVec):
            return NotImplemented
        if other.vocab is not self.vocab:
            return False
        a, b = self._pair(other)
        return bool(np.array_equal(a, b))

    def __repr__(self) -> str:
        self._sync()
        parts = [f"cpu {self._arr[CPU]:.2f}", f"memory {self._arr[MEMORY]:.2f}"]
        for name, dim in ((n, self.vocab.dim(n)) for n in self.vocab.names[2:]):
            if self._arr[dim] != 0:
                parts.append(f"{name} {self._arr[dim]:.2f}")
        return ", ".join(parts)


def sum_rows(reqs) -> Tuple[np.ndarray, bool]:
    """Dense [R] sum + ORed has_scalars over ResourceVecs — THE way to fold a
    batch of requests into one ``add_array``/``sub_array`` delta (keeps the
    has_scalars propagation rule in one place)."""
    rows = [r.array for r in reqs]
    has_scalars = any(r.has_scalars for r in reqs)
    return np.sum(rows, axis=0), has_scalars


def share(allocated: float, total: float) -> float:
    """Fraction helper with 0-total convention (reference api/helpers Share):
    0/0 -> 0, x/0 -> 1."""
    if total == 0.0:
        return 0.0 if allocated == 0.0 else 1.0
    return allocated / total


def res_min(a: ResourceVec, b: ResourceVec) -> ResourceVec:
    """Element-wise min as a new vector (reference helpers.Min)."""
    x, y = a._pair(b)
    return ResourceVec(a.vocab, np.minimum(x, y))
