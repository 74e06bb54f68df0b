"""Task status machine and status↔pod-phase mapping.

Reference: ``pkg/scheduler/api/types.go:26-108`` (TaskStatus bit values),
``helpers.go:40-76`` (pod→status mapping, AllocatedStatus).
"""

from __future__ import annotations

import enum

from scheduler_tpu_torch.apis.objects import PodPhase, PodSpec


class TaskStatus(enum.IntEnum):
    """Lifecycle status of a task; bit values so sets can be masks on device."""

    PENDING = 1 << 0     # not scheduled
    ALLOCATED = 1 << 1   # assigned this session, not yet dispatched
    PIPELINED = 1 << 2   # assigned onto releasing resources
    BINDING = 1 << 3     # bind request sent
    BOUND = 1 << 4       # bound, not yet running
    RUNNING = 1 << 5
    RELEASING = 1 << 6   # being evicted/deleted
    SUCCEEDED = 1 << 7
    FAILED = 1 << 8
    UNKNOWN = 1 << 9

    def __str__(self) -> str:  # match reference's human-readable histogram keys
        return self.name.capitalize()


# Statuses that occupy node resources as "owned" (helpers.go:69-76).
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING, TaskStatus.ALLOCATED}
)


def allocated_status(status: TaskStatus) -> bool:
    return status in ALLOCATED_STATUSES


def get_task_status(pod: PodSpec) -> TaskStatus:
    """Derive a task's status from its pod object (helpers.go:40-66)."""
    if pod.phase == PodPhase.RUNNING:
        if pod.deletion_timestamp is not None:
            return TaskStatus.RELEASING
        return TaskStatus.RUNNING
    if pod.phase == PodPhase.PENDING:
        if pod.deletion_timestamp is not None:
            return TaskStatus.RELEASING
        if pod.node_name:
            return TaskStatus.BOUND
        return TaskStatus.PENDING
    if pod.phase == PodPhase.UNKNOWN:
        return TaskStatus.UNKNOWN
    if pod.phase == PodPhase.SUCCEEDED:
        return TaskStatus.SUCCEEDED
    if pod.phase == PodPhase.FAILED:
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN
