"""API object model: the durable objects the scheduler operates on.

Standalone equivalents of the reference's CRD + core types
(``pkg/apis/scheduling/v1alpha1/types.go``, k8s Pod/Node): PodGroup and Queue are
the scheduler's own API surface; PodSpec and NodeSpec stand in for the Kubernetes
core objects the reference imports.  No kube dependency — the framework owns its
object model and any external system (k8s, a test harness, the synthetic workload
generator) adapts into it.
"""

from scheduler_tpu_torch.apis.objects import (
    Affinity,
    NodeSelectorRequirement,
    NodeSpec,
    PodCondition,
    PodGroup,
    PodGroupCondition,
    PodGroupPhase,
    PodGroupStatus,
    PodPhase,
    PodSpec,
    PodAffinityTerm,
    Queue,
    QueueStatus,
    Taint,
    Toleration,
    GROUP_NAME_ANNOTATION,
    NOT_ENOUGH_PODS_REASON,
    NOT_ENOUGH_RESOURCES_REASON,
    POD_GROUP_UNSCHEDULABLE_TYPE,
)

__all__ = [
    "Affinity",
    "NodeSelectorRequirement",
    "NodeSpec",
    "PodCondition",
    "PodGroup",
    "PodGroupCondition",
    "PodGroupPhase",
    "PodGroupStatus",
    "PodPhase",
    "PodSpec",
    "PodAffinityTerm",
    "Queue",
    "QueueStatus",
    "Taint",
    "Toleration",
    "GROUP_NAME_ANNOTATION",
    "NOT_ENOUGH_PODS_REASON",
    "NOT_ENOUGH_RESOURCES_REASON",
    "POD_GROUP_UNSCHEDULABLE_TYPE",
]
