"""Resource vocabulary: the dense dimensioning of resource vectors.

The reference keeps resources as ``MilliCPU``/``Memory`` fields plus a
``map[ResourceName]float64`` of scalars (``pkg/scheduler/api/resource_info.go:30-45``).
For a tensor-shaped data model every resource quantity must live at a fixed tensor
index, so a ResourceVocabulary assigns each resource name a dimension:

* dim 0: cpu (millicores)
* dim 1: memory (bytes)
* dim 2+: scalar resources (RAW units, e.g. GPUs as 1.0), append-only registration

The vocabulary also carries the per-dimension epsilon thresholds that reproduce the
reference's comparison semantics (``resource_info.go:70-72``: minMilliCPU=10,
minMemory=10MiB, minMilliScalar=10).  The reference stores scalars in
milli-units (``MilliValue``), so its epsilon of 10 milli == 0.01 raw units here
— same semantics, different unit convention.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from scheduler_tpu_torch.apis.objects import RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS

CPU = 0
MEMORY = 1

MIN_MILLI_CPU = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024
# 10 milli-units in the reference's scalar convention = 0.01 raw units here.
MIN_SCALAR = 10.0 / 1000.0


class ResourceVocabulary:
    """Append-only mapping of resource names to dense vector dimensions.

    One vocabulary is shared by a whole cluster/cache; ResourceVec instances lazily
    pad themselves when the vocabulary has grown since they were created, so
    registering a new scalar resource mid-flight is cheap and safe.
    """

    __slots__ = ("_index", "_names", "_mins", "_mins_arr")

    def __init__(self, scalar_names: Iterable[str] = ()) -> None:
        self._index: Dict[str, int] = {RESOURCE_CPU: CPU, RESOURCE_MEMORY: MEMORY}
        self._names: List[str] = [RESOURCE_CPU, RESOURCE_MEMORY]
        self._mins: List[float] = [MIN_MILLI_CPU, MIN_MEMORY]
        self._mins_arr: np.ndarray = np.asarray(self._mins, dtype=np.float64)
        for name in scalar_names:
            self.register(name)

    @property
    def size(self) -> int:
        return len(self._names)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._names)

    def register(self, name: str) -> int:
        """Register (or look up) a scalar resource; returns its dimension."""
        if name == RESOURCE_PODS:
            raise ValueError("'pods' is tracked as max_task_num, not a vector dim")
        dim = self._index.get(name)
        if dim is None:
            dim = len(self._names)
            self._index[name] = dim
            self._names.append(name)
            self._mins.append(MIN_SCALAR)
            self._mins_arr = np.asarray(self._mins, dtype=np.float64)
        return dim

    def dim(self, name: str) -> int:
        """Dimension of a known resource name (KeyError if unregistered)."""
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def min_thresholds(self) -> np.ndarray:
        """Per-dimension epsilon vector [R] (float64, cached — treat as read-only)."""
        return self._mins_arr

    def __repr__(self) -> str:
        return f"ResourceVocabulary({self._names!r})"


# Default process-wide vocabulary for convenience in tests and examples.
DEFAULT_VOCAB = ResourceVocabulary()
