"""Scheduler data model (reference ``pkg/scheduler/api``): dense resource vectors,
task/job/node/queue infos, the cluster snapshot, and the snapshot tensor encoding."""

from scheduler_tpu_torch.api.cluster_info import ClusterInfo
from scheduler_tpu_torch.api.job_info import (
    JobInfo,
    TaskInfo,
    job_id_for_pod,
    pod_resource_request,
    pod_resource_without_init,
)
from scheduler_tpu_torch.api.node_info import NodeInfo, NodeState
from scheduler_tpu_torch.api.queue_info import QueueInfo
from scheduler_tpu_torch.api.resource import ResourceVec, res_min, share
from scheduler_tpu_torch.api.types import ALLOCATED_STATUSES, TaskStatus, allocated_status, get_task_status
from scheduler_tpu_torch.api.unschedule_info import (
    ALL_NODE_UNAVAILABLE,
    NODE_POD_NUMBER_EXCEEDED,
    NODE_RESOURCE_FIT_FAILED,
    FitError,
    FitErrors,
)
from scheduler_tpu_torch.api.vocab import (
    CPU,
    MEMORY,
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_SCALAR,
    DEFAULT_VOCAB,
    ResourceVocabulary,
)

__all__ = [
    "ClusterInfo",
    "JobInfo",
    "TaskInfo",
    "job_id_for_pod",
    "pod_resource_request",
    "pod_resource_without_init",
    "NodeInfo",
    "NodeState",
    "QueueInfo",
    "ResourceVec",
    "res_min",
    "share",
    "ALLOCATED_STATUSES",
    "TaskStatus",
    "allocated_status",
    "get_task_status",
    "ALL_NODE_UNAVAILABLE",
    "NODE_POD_NUMBER_EXCEEDED",
    "NODE_RESOURCE_FIT_FAILED",
    "FitError",
    "FitErrors",
    "CPU",
    "MEMORY",
    "MIN_MEMORY",
    "MIN_MILLI_CPU",
    "MIN_SCALAR",
    "DEFAULT_VOCAB",
    "ResourceVocabulary",
]
