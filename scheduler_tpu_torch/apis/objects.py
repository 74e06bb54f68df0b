"""The framework's API objects.

PodGroup / Queue mirror the reference CRDs (``pkg/apis/scheduling/v1alpha1/types.go:93-223``);
PodSpec / NodeSpec are standalone stand-ins for the Kubernetes core objects
(pod spec incl. containers/affinity/tolerations, node allocatable/capacity/taints)
that the reference gets from ``k8s.io/api/core/v1``.

Resource quantities are plain ``{name: float}`` dicts in *canonical units*:
``cpu`` in millicores, ``memory`` in bytes, ``pods`` as a count, and every other
(scalar) resource in RAW units (e.g. GPUs as 1.0) — the reference canonicalizes
scalars to milli-units in ``NewResource`` (``pkg/scheduler/api/resource_info.go:75-93``);
here the vocabulary's epsilon carries the unit conversion instead
(``api/vocab.py``: 10 milli == 0.01 raw).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Well-known resource names (canonical units in parentheses).
RESOURCE_CPU = "cpu"            # millicores
RESOURCE_MEMORY = "memory"      # bytes
RESOURCE_PODS = "pods"          # count; feeds Resource.max_task_num, not the vector
GPU_RESOURCE_NAME = "nvidia.com/gpu"   # reference resource_info.go:44
TPU_RESOURCE_NAME = "google.com/tpu"   # first-class accelerator resource here

# Annotation linking a bare pod to its PodGroup (reference apis/.../labels.go:21).
GROUP_NAME_ANNOTATION = "scheduling.k8s.io/group-name"

# PodGroup condition/reason constants (reference types.go:139-171).
POD_GROUP_UNSCHEDULABLE_TYPE = "Unschedulable"
NOT_ENOUGH_PODS_REASON = "NotEnoughPods"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    """Process-unique object UID (stand-in for the apiserver's UUIDs)."""
    return f"{prefix}-{next(_uid_counter)}"


def now() -> float:
    return time.time()


class PodPhase:
    """Pod lifecycle phase (k8s core/v1 PodPhase equivalent)."""

    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


class PodGroupPhase:
    """PodGroup lifecycle phase (reference types.go:24-46)."""

    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


@dataclass
class PodGroupCondition:
    """Status condition on a PodGroup (reference types.go:139-160)."""

    type: str
    status: str = "True"
    transition_id: str = ""
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=now)


@dataclass
class PodGroupStatus:
    phase: str = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0

    def clone(self) -> "PodGroupStatus":
        return PodGroupStatus(
            phase=self.phase,
            conditions=list(self.conditions),
            running=self.running,
            succeeded=self.succeeded,
            failed=self.failed,
        )


@dataclass
class PodGroup:
    """A gang: the minimal co-scheduled unit (reference types.go:93-135).

    ``min_member`` tasks must be placeable together or none runs; ``min_resources``
    gates admission in the enqueue action.
    """

    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pg"))
    min_member: int = 0
    queue: str = "default"
    priority_class_name: str = ""
    min_resources: Optional[Dict[str, float]] = None
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
    creation_timestamp: float = field(default_factory=now)
    # True for cache-synthesized groups covering bare pods (reference
    # cache/util.go:30-63).  Shadow groups exist ONLY in this process — a
    # relist diff against the system of record must never prune them.
    shadow: bool = False


@dataclass
class QueueStatus:
    unknown: int = 0
    pending: int = 0
    running: int = 0


@dataclass
class Queue:
    """A weighted tenant queue (reference types.go:178-223)."""

    name: str
    uid: str = field(default_factory=lambda: new_uid("queue"))
    weight: int = 1
    # Resource quota cap for the queue; empty dict = uncapped.
    capability: Dict[str, float] = field(default_factory=dict)
    status: QueueStatus = field(default_factory=QueueStatus)
    creation_timestamp: float = field(default_factory=now)


@dataclass
class Toleration:
    """Taint toleration (k8s core/v1 Toleration equivalent)."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""         # "" tolerates all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class NodeSelectorRequirement:
    """A single match expression: key op values (k8s NodeSelectorRequirement)."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        val = labels.get(self.key)
        if self.operator == "In":
            return val is not None and val in self.values
        if self.operator == "NotIn":
            return val is None or val not in self.values
        if self.operator == "Exists":
            return val is not None
        if self.operator == "DoesNotExist":
            return val is None
        if self.operator == "Gt":
            return val is not None and val.isdigit() and int(val) > int(self.values[0])
        if self.operator == "Lt":
            return val is not None and val.isdigit() and int(val) < int(self.values[0])
        raise ValueError(f"unknown node selector operator {self.operator!r}")


@dataclass
class PodAffinityTerm:
    """Pod (anti-)affinity term: match pods by labels, co/counter-locate by
    topology.  ``label_selector`` carries matchLabels (exact pairs);
    ``expressions`` carries matchExpressions (operator requirements) — a pod
    matches when BOTH hold (k8s labels.Selector semantics)."""

    label_selector: Dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)
    expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches_labels(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.label_selector.items()) and all(
            r.matches(labels) for r in self.expressions
        )


@dataclass
class Affinity:
    """Node + pod affinity constraints.  ``*_required``/``pod_affinity``/
    ``pod_anti_affinity`` are hard terms (predicate path); the ``*_preferred``
    forms are (weight, term) pairs feeding node scoring — preferred node
    affinity in the nodeorder score, preferred pod (anti-)affinity in the
    InterPodAffinity batch priority (nodeorder.go:229-247)."""

    # OR over groups, AND within a group (nodeSelectorTerms semantics).
    node_required: List[List[NodeSelectorRequirement]] = field(default_factory=list)
    # Preferred node affinity: (weight, requirements) pairs for the scorer.
    node_preferred: List[Tuple[int, List[NodeSelectorRequirement]]] = field(default_factory=list)
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity: List[PodAffinityTerm] = field(default_factory=list)
    # Preferred pod (anti-)affinity: (weight, term) pairs.
    pod_preferred: List[Tuple[int, PodAffinityTerm]] = field(default_factory=list)
    pod_anti_preferred: List[Tuple[int, PodAffinityTerm]] = field(default_factory=list)


@dataclass
class PodSpec:
    """The unit of work (k8s core/v1 Pod equivalent).

    ``containers`` / ``init_containers`` are lists of resource-request dicts; the
    effective request follows the k8s rule max(sum(containers), max(init_containers))
    (reference ``pod_info.go:53-76``).
    """

    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pod"))
    containers: List[Dict[str, float]] = field(default_factory=list)
    init_containers: List[Dict[str, float]] = field(default_factory=list)
    node_name: str = ""          # bound node ("" = unbound)
    phase: str = PodPhase.PENDING
    priority: int = 0
    priority_class_name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    host_ports: List[int] = field(default_factory=list)
    # PersistentVolumeClaim names this pod mounts; drives the VolumeBinder
    # allocate/bind RPCs (reference cache.go:189-209 via k8s volumebinder).
    volume_claims: List[str] = field(default_factory=list)
    scheduler_name: str = ""
    deletion_timestamp: Optional[float] = None
    creation_timestamp: float = field(default_factory=now)

    @property
    def group_name(self) -> str:
        return self.annotations.get(GROUP_NAME_ANNOTATION, "")


@dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    message: str = ""


@dataclass
class NodeSpec:
    """A schedulable node (k8s core/v1 Node equivalent)."""

    name: str
    uid: str = field(default_factory=lambda: new_uid("node"))
    allocatable: Dict[str, float] = field(default_factory=dict)
    capacity: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    # Node conditions as {type: status}; e.g. {"Ready": "True"}.
    conditions: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = field(default_factory=now)

    def __post_init__(self) -> None:
        if not self.capacity:
            self.capacity = dict(self.allocatable)
