"""Enqueue: gate Pending PodGroups into the Inqueue phase
(reference ``actions/enqueue/enqueue.go``; ``scheduler_tpu/actions/enqueue.py``).

Admission throttles pod-creation pressure: a job enters the rotation only
when its MinResources fits the cluster's remaining idle (with the
reference's 1.2x overcommit, enqueue.go:78-81) and every JobEnqueueable
plugin agrees (proportion's).  The other actions skip PodGroup-Pending
jobs, so this is the front door.
"""

from __future__ import annotations

import logging
from typing import Dict

from scheduler_tpu_torch.api.resource import ResourceVec
from scheduler_tpu_torch.apis.objects import PodGroupPhase
from scheduler_tpu_torch.framework.interface import Action
from scheduler_tpu_torch.utils.priority_queue import PriorityQueue

logger = logging.getLogger("scheduler_tpu_torch.actions.enqueue")

OVERCOMMIT_FACTOR = 1.2


class EnqueueAction(Action):
    def name(self) -> str:
        return "enqueue"

    def execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_seen: set = set()
        jobs_map: Dict[str, PriorityQueue] = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                logger.error("failed to find queue %s for job %s", job.queue, job.uid)
                continue
            if queue.uid not in queue_seen:
                queue_seen.add(queue.uid)
                queues.push(queue)
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                jobs_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)

        if not ssn.jobs:
            return
        vocab = next(iter(ssn.jobs.values())).vocab

        empty = ResourceVec.empty(vocab)
        nodes_idle = ResourceVec.empty(vocab)
        ledger = getattr(ssn.nodes, "ledger", None)
        if ledger is not None:
            # The overcommitted-idle estimate as two column sums of the
            # ledger, with no node views.
            if ledger.r < vocab.size:
                ledger.widen(vocab.size)
            est = ledger.total_allocatable() * OVERCOMMIT_FACTOR - ledger.total_used()
            nodes_idle.add_array(
                est[: vocab.size],
                ledger.any_alloc_scalars() or ledger.any_used_scalars(),
            )
        else:
            for node in ssn.nodes.values():
                nodes_idle.add(node.allocatable.clone().multi(OVERCOMMIT_FACTOR).sub(node.used))

        while not queues.empty():
            if nodes_idle.less(empty):
                logger.debug("cluster idle resource exhausted, stopping enqueue")
                break

            queue = queues.pop()
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            if job.pod_group.min_resources is None:
                inqueue = True
            else:
                pg_resource = ResourceVec.from_dict(job.pod_group.min_resources, vocab)
                if ssn.job_enqueueable(job) and pg_resource.less_equal(nodes_idle):
                    nodes_idle.sub(pg_resource)
                    inqueue = True

            if inqueue:
                job.pod_group.status.phase = PodGroupPhase.INQUEUE

            queues.push(queue)


def new() -> EnqueueAction:
    return EnqueueAction()
