"""The cache seam: Cache plus its side-effect interfaces
(reference ``pkg/scheduler/cache/interface.go:27-78``).

Binder/Evictor/StatusUpdater/VolumeBinder are the only places the scheduler
touches the outside world; swapping fakes in makes every action testable without
a cluster — the reference's key test pattern (SURVEY.md §4b) preserved here.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from scheduler_tpu_torch.api.cluster_info import ClusterInfo
    from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
    from scheduler_tpu_torch.apis.objects import PodSpec


class BulkBindError(Exception):
    """Raised by ``Binder.bind_bulk`` when only part of a batch failed.

    ``failed`` holds the ``(pod, hostname)`` pairs that did NOT bind; every
    other pair in the batch is guaranteed applied.  This lets the cache resync
    exactly the failed pods instead of reverting pods that are really bound.
    """

    def __init__(self, failed: list) -> None:
        super().__init__(f"{len(failed)} binds failed")
        self.failed = failed


class Binder(abc.ABC):
    @abc.abstractmethod
    def bind(self, pod: "PodSpec", hostname: str) -> None: ...

    def bind_bulk(self, pairs: list) -> None:
        """Bind many ``(pod, hostname)`` pairs in one call.

        Contract: either succeed for the whole batch, or raise
        ``BulkBindError`` listing exactly the pairs that failed (any other
        exception means the caller must assume NOTHING in the batch applied).
        The default falls back to per-pod ``bind`` and collects failures.
        """
        failed = []
        for pod, hostname in pairs:
            try:
                self.bind(pod, hostname)
            except Exception:
                failed.append((pod, hostname))
        if failed:
            raise BulkBindError(failed)

    def bind_rows(self, pods, hostnames) -> None:
        """Columnar ``bind_bulk``: parallel pod/hostname sequences, no pair
        tuples.  ``pods`` elements only promise ``.namespace``/``.name`` (task
        cores satisfy this as well as PodSpecs).  Same failure contract as
        ``bind_bulk``; the default zips into it for binders that predate the
        columnar path."""
        self.bind_bulk(list(zip(pods, hostnames)))

    def close(self) -> None:
        """The cache is stopping: a bind that waits on an answer gives up
        (the wire binders resend an unanswered bind until then)."""


class Evictor(abc.ABC):
    @abc.abstractmethod
    def evict(self, pod: "PodSpec") -> None: ...


class StatusUpdater(abc.ABC):
    """Pushes pod conditions and PodGroup status back to the system of record."""

    @abc.abstractmethod
    def update_pod_condition(self, pod: "PodSpec", condition) -> None: ...

    @abc.abstractmethod
    def update_pod_group(self, job: "JobInfo") -> None: ...

    # The cache builds event payloads ONLY when this is True — a no-op
    # recorder must not cost 100k dict constructions per cycle.
    RECORDS_EVENTS = False

    def record_events(self, events: list) -> None:
        """Emit lifecycle events — the reference's Recorder.Eventf calls on
        Scheduled / Evict / FailedScheduling (cache.go:482,440,516).  Each
        event is a dict: {"namespace", "name", "type", "reason", "message"}.
        Batched (one call per bind/evict chunk) and best-effort: the default
        drops them, implementations must never let an event failure affect
        scheduling."""


class VolumeBinder(abc.ABC):
    @abc.abstractmethod
    def allocate_volumes(self, task: "TaskInfo", hostname: str) -> None: ...

    @abc.abstractmethod
    def bind_volumes(self, task: "TaskInfo") -> None: ...


class Cache(abc.ABC):
    """What a Session needs from the cluster-state mirror (interface.go:27-56)."""

    @abc.abstractmethod
    def run(self) -> None: ...

    @abc.abstractmethod
    def snapshot(self) -> "ClusterInfo": ...

    @abc.abstractmethod
    def bind(self, task: "TaskInfo", hostname: str) -> None: ...

    def bind_bulk(self, tasks: list) -> None:
        """Bind many tasks (each carrying its node_name) in one call.  Default
        falls back to per-task ``bind``; implementations may batch the state
        update and the async API dispatch."""
        for task in tasks:
            self.bind(task, task.node_name)

    @abc.abstractmethod
    def evict(self, task: "TaskInfo", reason: str) -> None: ...

    @abc.abstractmethod
    def update_job_status(self, job: "JobInfo", update_pg: bool = True) -> Optional["JobInfo"]: ...

    @abc.abstractmethod
    def record_job_status_event(self, job: "JobInfo") -> None: ...

    @abc.abstractmethod
    def allocate_volumes(self, task: "TaskInfo", hostname: str) -> None: ...

    @abc.abstractmethod
    def bind_volumes(self, task: "TaskInfo") -> None: ...

    # -- columnar commit hooks (device-engine extension) -------------------------
    # Defaults materialize task views and delegate to the per-task methods, so
    # any Cache implementation is automatically columnar-capable; the real
    # SchedulerCache overrides these with vectorized versions.

    def allocate_volumes_rows(self, job: "JobInfo", rows, names) -> None:
        for r, name in zip(rows, names):
            self.allocate_volumes(job.view_for_row(int(r)), name)

    def bind_volumes_rows(self, job: "JobInfo", rows) -> None:
        for r in rows:
            self.bind_volumes(job.view_for_row(int(r)))

    def bind_bulk_columnar(self, items: list, plan) -> None:
        """Bind (session_job, rows, node_ids) batches.  Default: materialize
        and use the object path."""
        tasks = [job.view_for_row(int(r)) for job, rows, _ids in items for r in rows]
        self.bind_bulk(tasks)
