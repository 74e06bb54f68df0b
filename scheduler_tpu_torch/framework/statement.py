"""Statement: the all-or-nothing transaction used by gang preemption
(reference ``framework/statement.go``).

Evict/Pipeline apply to session state eagerly and are recorded; ``commit``
replays evictions against the cache, ``discard`` rolls everything back in
reverse order (unevict restores Running, unpipeline restores Pending).
"""

from __future__ import annotations

import logging
from typing import List, TYPE_CHECKING, Tuple

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.types import TaskStatus

if TYPE_CHECKING:
    from scheduler_tpu_torch.framework.session import Session

logger = logging.getLogger("scheduler_tpu_torch.statement")


class Statement:
    def __init__(self, ssn: "Session") -> None:
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []

    # -- eager session-state ops ---------------------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append(("evict", (reclaimee, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        else:
            logger.error("failed to find node %s for pipeline", hostname)
        self.ssn._fire_allocate(task)
        self.operations.append(("pipeline", (task, hostname)))

    # -- rollback primitives --------------------------------------------------

    def _unevict(self, reclaimee: TaskInfo) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RUNNING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_allocate(reclaimee)

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            try:
                node.remove_task(task)
            except KeyError:
                logger.error("failed to remove pipelined task %s from %s", task.uid, task.node_name)
        task.node_name = ""
        self.ssn._fire_deallocate(task)

    # -- outcome ---------------------------------------------------------------

    def commit(self, on_evicted=None) -> None:
        """Replay recorded evictions against the cache (pipelines stay session-only).

        ``on_evicted(task)`` fires only for evictions whose SESSION state
        sticks.  Under sync dispatch (``async_io=False``) a failed evict RPC
        raises here and ``_unevict`` restores the session victim — it remains
        offerable, so success-keyed bookkeeping (the VictimGate's live
        counts) must not see it.  Under async dispatch ``cache.evict``
        returning means "accepted for dispatch": a later RPC failure is
        repaired on the CACHE's objects by its resync path (fire-and-forget,
        like the reference's eviction goroutines) and never touches the
        session's snapshot-isolated clone — the session victim stays
        RELEASING and is un-offerable either way, so firing at commit is
        correct for everything scoped to this session."""
        for name, args in self.operations:
            if name == "evict":
                reclaimee, reason = args
                try:
                    self.ssn.cache.evict(reclaimee, reason)
                except Exception:
                    logger.exception("cache evict failed for %s; restoring", reclaimee.uid)
                    self._unevict(reclaimee)
                else:
                    if on_evicted is not None:
                        on_evicted(reclaimee)
        self.operations = []

    def discard(self) -> None:
        logger.debug("discarding statement operations")
        for name, args in reversed(self.operations):
            if name == "evict":
                self._unevict(args[0])
            elif name == "pipeline":
                self._unpipeline(args[0])
        self.operations = []
