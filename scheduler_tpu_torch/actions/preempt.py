"""Preempt: intra-queue eviction for starved high-priority jobs
(reference ``actions/preempt/preempt.go``).

Phase 1: within each queue, jobs with pending tasks preempt Running tasks of
*other* jobs in the same queue, under a Statement — evictions commit only once
the preemptor job is gang-pipelined, otherwise everything rolls back.  Phase 2:
intra-job task preemption (higher-priority pending tasks of a job evict its own
lower-priority running tasks), committed per task.

The hunt is the reference per-node walk (the default ``host`` flavor), with
the sweep memo (``utils/sweep.py``), the victim pre-gate (``ops/victims.py``)
and the live gang floor (``ops/evict.py``).  Under
``SCHEDULER_TORCH_EVICT=device`` the eviction engine (``ops/evict.py``)
plans each hunt batched and the Statement replays the plan, with the same
evictions and binds as the host walk.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.resource import ResourceVec
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.apis.objects import PodGroupPhase
from scheduler_tpu_torch.framework.interface import Action
from scheduler_tpu_torch.framework.statement import Statement
from scheduler_tpu_torch.utils import metrics
from scheduler_tpu_torch.utils.priority_queue import PriorityQueue

logger = logging.getLogger("scheduler_tpu_torch.actions.preempt")


class PreemptAction(Action):
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn) -> None:
        from scheduler_tpu_torch.ops import evict as evict_ops
        from scheduler_tpu_torch.ops.victims import VictimGate
        from scheduler_tpu_torch.utils.scheduler_helper import (
            build_preemptor_task_queue,
            enabled_task_order_chain,
            task_order_builtin,
        )
        from scheduler_tpu_torch.utils.sweep import SweepCache

        # O(1)-per-task sweep memoization + the victim pre-gate: one masked
        # reduction over the running tasks admits exactly the nodes that can
        # still yield a victim; the per-node dispatch below stays exact.
        # An active eviction engine replaces the per-node hunt with a batched
        # victim plan the Statement replays; the pre-gate then stands down
        # (the engine's masks subsume it).
        sweep = SweepCache(ssn)
        engine = evict_ops.EvictEngine(ssn, "preempt")
        gate = None if engine.active else VictimGate(ssn, "preempt")
        builtin_order = task_order_builtin(ssn)
        use_priority = "priority" in enabled_task_order_chain(ssn)

        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, object] = {}
        under_request: List[JobInfo] = []
        queues = {}

        for job in ssn.jobs.values():
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)

            if job.status_count(TaskStatus.PENDING):
                preemptors_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                under_request.append(job)
                preemptor_tasks[job.uid] = build_preemptor_task_queue(
                    ssn, job, builtin_order, use_priority
                )

        if gate is not None:
            if preemptor_tasks:
                # Snapshot BEFORE the first Statement: a build inside an open
                # statement would see temporarily-low gang occupancy that a
                # rollback later restores (ops/victims.py docstring).
                gate.prime()
            else:
                gate = None
        if engine.active and preemptor_tasks:
            # Same capture rule as the gate: the victim table must see the
            # action's start state (prime can still deactivate the engine —
            # scalar resources in play — and then the host walk below runs
            # ungated for this action).
            engine.prime()

        # Phase 1: preemption between jobs within a queue.
        for queue in queues.values():
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement()
                assigned = False
                while True:
                    if preemptor_tasks[preemptor_job.uid].empty():
                        logger.debug("no preemptor task in job %s", preemptor_job.uid)
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task: TaskInfo) -> bool:
                        if task.status != TaskStatus.RUNNING:
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        # Preempt other jobs within the same queue.
                        return job.queue == preemptor_job.queue and preemptor.job != task.job

                    if self._preempt(
                        ssn,
                        stmt,
                        preemptor,
                        job_filter,
                        sweep=sweep,
                        node_gate=(
                            None
                            if gate is None
                            else lambda node, j=preemptor_job: gate.admits_other_job(
                                node.name, j
                            )
                        ),
                        engine=engine,
                        preemptor_job=preemptor_job,
                        same_job=False,
                    ):
                        assigned = True

                    if ssn.job_pipelined(preemptor_job):
                        # Gate counts drop per ACCEPTED evict (a failed evict
                        # RPC restores the victim, which stays offerable).
                        ops = list(stmt.operations)
                        stmt.commit(
                            on_evicted=None if gate is None else gate.note_evicted_task
                        )
                        if engine.active:
                            # Failed evict RPCs restored their victims at the
                            # END of the node map; re-sync the captured
                            # candidate order.
                            engine.note_commit(ops)
                        break

                if not ssn.job_pipelined(preemptor_job):
                    if engine.active:
                        # BEFORE discard: the rollback re-appends restored
                        # victims at the end of their node maps.
                        engine.note_discard(stmt)
                    stmt.discard()
                    continue

                if assigned:
                    preemptors.push(preemptor_job)

        # Phase 2: preemption between tasks within one job — ONCE, after every
        # queue's phase 1 (preempt.go:144-174).  Running it inside the queue
        # loop would drain a preemptor job's task queue while iterating an
        # UNRELATED queue, silently disabling cross-job preemption for any
        # queue that is not first in iteration order.
        for job in under_request:
            while True:
                tasks = preemptor_tasks.get(job.uid)
                if tasks is None or tasks.empty():
                    break
                preemptor = tasks.pop()

                stmt = ssn.statement()
                assigned = self._preempt(
                    ssn,
                    stmt,
                    preemptor,
                    lambda task: task.status == TaskStatus.RUNNING
                    and preemptor.job == task.job,
                    sweep=sweep,
                    node_gate=(
                        None
                        if gate is None
                        else lambda node, j=job: gate.admits_own_job(node.name, j)
                    ),
                    engine=engine,
                    preemptor_job=job,
                    same_job=True,
                )
                ops = list(stmt.operations)
                stmt.commit(on_evicted=None if gate is None else gate.note_evicted_task)
                if engine.active:
                    engine.note_commit(ops)
                if not assigned:
                    break

        evict_ops.note_evidence("preempt", engine.stats())
        VictimGate.note_evidence("preempt", gate)

    def _preempt(
        self,
        ssn,
        stmt: Statement,
        preemptor: TaskInfo,
        task_filter: Optional[Callable[[TaskInfo], bool]],
        sweep=None,
        node_gate: Optional[Callable] = None,
        engine=None,
        preemptor_job=None,
        same_job: bool = False,
    ) -> bool:
        """One preemptor's hunt for a node (reference preempt.go:180-260).

        ``sweep`` (utils.sweep.SweepCache) memoizes the predicate+score node
        ordering per task signature; ``node_gate`` skips nodes the gate
        proved to hold no candidate Running tasks.  Both are exact filters —
        when either declines (None / dynamic task), the reference's per-task
        sweep runs unchanged.  An ACTIVE ``engine`` (``ops/evict.py``,
        ``SCHEDULER_TORCH_EVICT=device``) runs the whole hunt as a batched
        victim plan instead; a task outside its modeled domain (scalar
        requests) falls back to this host walk."""
        from scheduler_tpu_torch.ops.evict import FloorGuard, _FallbackHunt
        from scheduler_tpu_torch.utils.sweep import full_sweep

        assigned = False
        ordered = sweep.ordered_nodes(preemptor) if sweep is not None else None
        pod_count_live = sweep is not None and ordered is not None
        if ordered is None:
            ordered = full_sweep(ssn, preemptor, ssn.predicate_fn)
        if engine is not None and engine.active and preemptor_job is not None:
            try:
                return engine.hunt_preempt(stmt, preemptor, preemptor_job, ordered, sweep,
                                           pod_count_live, same_job)
            except _FallbackHunt:
                pass  # scalar request: the host walk below stays exact

        # The live gang floor: one hunt's sufficiency prefix must never
        # strand a cohort below min_member.
        guard = FloorGuard.for_session(ssn, "preempt")
        for node in ordered:
            if pod_count_live and not sweep.node_open(node):
                continue
            if node_gate is not None and not node_gate(node):
                continue
            logger.debug("considering task %s on node %s", preemptor.uid, node.name)

            preemptees = [
                task.clone()
                for task in node.tasks.values()
                if task_filter is None or task_filter(task)
            ]
            victims = ssn.preemptable(preemptor, preemptees)
            metrics.update_preemption_victims_count(len(victims))

            if not self._validate_victims(victims, preemptor.init_resreq):
                logger.debug("no validated victims on node %s", node.name)
                continue

            # Evict cheapest victims first (reverse task order, preempt.go:219-224).
            victims_queue = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
            for victim in victims:
                victims_queue.push(victim)

            preempted = ResourceVec.empty(preemptor.resreq.vocab)
            resreq = preemptor.init_resreq.clone()
            while not victims_queue.empty():
                preemptee = victims_queue.pop()
                if guard is not None and not guard.take(preemptee):
                    logger.debug("skipping victim %s: gang floor", preemptee.uid)
                    continue
                logger.info("preempting task %s for %s", preemptee.uid, preemptor.uid)
                stmt.evict(preemptee, "preempt")
                preempted.add(preemptee.resreq)
                if resreq.less_equal(preempted):
                    break

            metrics.register_preemption_attempts()

            if preemptor.init_resreq.less_equal(preempted):
                stmt.pipeline(preemptor, node.name)
                assigned = True
                break

        return assigned

    @staticmethod
    def _validate_victims(victims: List[TaskInfo], resreq: ResourceVec) -> bool:
        """Victims exist and could cover the request (preempt.go:262-277)."""
        if not victims:
            return False
        total = ResourceVec.empty(resreq.vocab)
        for v in victims:
            total.add(v.resreq)
        return not total.less(resreq)


def new() -> PreemptAction:
    return PreemptAction()
