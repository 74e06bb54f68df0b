"""Reclaim: cross-queue eviction to enforce weighted queue shares
(reference ``actions/reclaim/reclaim.go``).

For a starved queue's pending task, Running tasks of *other* queues are
candidate reclaimees per node; the Reclaimable dispatch (proportion: victim's
queue must stay >= its deserved share; gang: victim's gang must survive) picks
victims, which are evicted directly — no Statement — then the task pipelines
onto the freed resources.

The hunt is the reference per-node walk (the default ``host`` flavor), with
the sweep memo (``utils/sweep.py``), the victim pre-gate (``ops/victims.py``)
and the live gang floor (``ops/evict.py``).  Under
``SCHEDULER_TORCH_EVICT=device`` the eviction engine (``ops/evict.py``)
plans each hunt batched and this action replays the plan, with the same
evictions and pipelines as the host walk.
"""

from __future__ import annotations

import logging
from typing import Dict

from scheduler_tpu_torch.api.resource import ResourceVec
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.apis.objects import PodGroupPhase
from scheduler_tpu_torch.framework.interface import Action
from scheduler_tpu_torch.utils.priority_queue import PriorityQueue
from scheduler_tpu_torch.utils.scheduler_helper import get_node_list

logger = logging.getLogger("scheduler_tpu_torch.actions.reclaim")


class ReclaimAction(Action):
    def name(self) -> str:
        return "reclaim"

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
        # An active eviction engine plans the whole hunt batched and this
        # action replays it; the pre-gate then stands down (the engine's
        # masks subsume it).
        sweep = SweepCache(ssn)
        engine = evict_ops.EvictEngine(ssn, "reclaim")
        gate = None if engine.active else VictimGate(ssn, "reclaim")
        builtin_order = task_order_builtin(ssn)
        use_priority = "priority" in enabled_task_order_chain(ssn)

        queues = PriorityQueue(ssn.queue_order_fn)
        queue_seen: set = set()
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, object] = {}

        for job in ssn.jobs.values():
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                logger.error("failed to find queue %s for job %s", job.queue, job.uid)
                continue
            if queue.uid not in queue_seen:
                queue_seen.add(queue.uid)
                queues.push(queue)

            if job.status_count(TaskStatus.PENDING):
                preemptors_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                preemptor_tasks[job.uid] = build_preemptor_task_queue(
                    ssn, job, builtin_order, use_priority
                )

        if gate is not None:
            if preemptor_tasks:
                gate.prime()  # snapshot BEFORE any eviction mutates state
            else:
                gate = None
        if engine.active and preemptor_tasks:
            engine.prime()  # same capture rule: the action's start state

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                logger.debug("queue %s is overused, skipping reclaim", queue.name)
                continue

            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            # Name-ordered like the reference (no scoring in reclaim,
            # reclaim.go:134-141); the cached set already applied the static
            # predicate, the live pod-count gate applies per candidate.
            ordered = sweep.passing_nodes(task)
            pod_count_live = ordered is not None
            if ordered is None:
                ordered = get_node_list(ssn.nodes)
            if engine.active:
                try:
                    assigned = self._hunt_device(
                        ssn, engine, task, job, ordered, sweep, pod_count_live)
                except evict_ops._FallbackHunt:
                    # Scalar request: outside the engine's modeled domain,
                    # the host walk stays exact for this task.
                    assigned = self._hunt_host(
                        ssn, gate, task, job, ordered, sweep, pod_count_live)
            else:
                assigned = self._hunt_host(ssn, gate, task, job, ordered, sweep, pod_count_live)
            if assigned:
                queues.push(queue)

        evict_ops.note_evidence("reclaim", engine.stats())
        VictimGate.note_evidence("reclaim", gate)

    def _hunt_host(self, ssn, gate, task, job, ordered, sweep, pod_count_live) -> bool:
        """The reference per-node walk (reclaim.go:134-195), pre-gated by the
        VictimGate's masked reduction and floor-guarded per hunt."""
        from scheduler_tpu_torch.ops.evict import FloorGuard

        guard = FloorGuard.for_session(ssn, "reclaim")
        # ONE masked reduction per hunt (live proportion margins) — the
        # per-node dispatch below only runs on admitted nodes, and the
        # admitted set itself comes from one vectorized gather.
        mask = gate.other_queue_mask(job.queue) if gate is not None else None
        if mask is not None:
            candidates = (
                ordered[i]
                for i in gate.admitted_positions(ordered, mask).tolist()
            )
        else:
            candidates = iter(ordered)
        for node in candidates:
            if pod_count_live:
                if not sweep.node_open(node):
                    continue
            else:
                try:
                    ssn.predicate_fn(task, node)
                except Exception:
                    continue

            resreq = task.init_resreq.clone()
            reclaimed = ResourceVec.empty(resreq.vocab)

            reclaimees = []
            for candidate in node.tasks.values():
                if candidate.status != TaskStatus.RUNNING:
                    continue
                owner = ssn.jobs.get(candidate.job)
                if owner is None:
                    continue
                if owner.queue != job.queue:
                    reclaimees.append(candidate.clone())

            victims = ssn.reclaimable(task, reclaimees)
            if not victims:
                logger.debug("no reclaim victims on node %s", node.name)
                continue

            total = ResourceVec.empty(resreq.vocab)
            for v in victims:
                total.add(v.resreq)
            if total.less(resreq):
                logger.debug("not enough reclaimable resource on node %s", node.name)
                continue

            # The sufficiency prefix is decided BEFORE evicting so the whole
            # hunt commits as one bulk eviction.  On the rare partial failure
            # (a victim vanished from the cache mid-action), the remaining
            # candidates top up one at a time.  The gang floor (``guard``)
            # skips — without evicting — any victim whose eviction would
            # strand its cohort below min_member.
            chosen = []
            rest_start = len(victims)
            planned = ResourceVec.empty(resreq.vocab)
            for idx, reclaimee in enumerate(victims):
                if guard is not None and not guard.take(reclaimee):
                    logger.debug("skipping victim %s: gang floor", reclaimee.uid)
                    continue
                chosen.append(reclaimee)
                planned.add(reclaimee.resreq)
                if resreq.less_equal(planned):
                    rest_start = idx + 1
                    break
            for reclaimee in chosen:
                logger.info("reclaiming task %s for %s", reclaimee.uid, task.uid)
            try:
                evicted = ssn.evict_bulk(chosen, "reclaim")
            except Exception:
                logger.exception("bulk reclaim failed on node %s", node.name)
                evicted = []
            for reclaimee in evicted:
                if gate is not None:
                    owner = ssn.jobs.get(reclaimee.job)
                    if owner is not None:
                        gate.note_eviction(node.name, owner)
                reclaimed.add(reclaimee.resreq)
            if len(evicted) < len(chosen):
                for reclaimee in victims[rest_start:]:
                    if resreq.less_equal(reclaimed):
                        break
                    if guard is not None and not guard.take(reclaimee):
                        continue
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except Exception:
                        logger.exception("failed to reclaim %s", reclaimee.uid)
                        continue
                    if gate is not None:
                        owner = ssn.jobs.get(reclaimee.job)
                        if owner is not None:
                            gate.note_eviction(node.name, owner)
                    reclaimed.add(reclaimee.resreq)

            if task.init_resreq.less_equal(reclaimed):
                try:
                    ssn.pipeline(task, node.name)
                except Exception:
                    logger.exception("failed to pipeline %s on %s", task.uid, node.name)
                return True
        return False

    def _hunt_device(self, ssn, engine, task, job, ordered, sweep, pod_count_live) -> bool:
        """Replay the eviction engine's victim plans: per planned node, one
        bulk eviction of the sufficiency prefix, the partial-failure top-up
        from the remaining kept victims, then the pipeline — the host walk's
        choreography, driven by batched masks instead of per-node
        dispatches.  An unsatisfied node loops back into the engine, which
        re-plans on the live ledgers."""
        import time

        start = 0
        while True:
            found = engine.next_reclaim_node(task, job, ordered, start, sweep, pod_count_live)
            if found is None:
                return False
            node, views, prefix, start = found
            resreq = task.init_resreq.clone()
            reclaimed = ResourceVec.empty(resreq.vocab)
            chosen = views[:prefix]
            for reclaimee in chosen:
                logger.info("reclaiming task %s for %s (device plan)", reclaimee.uid, task.uid)
            t0 = time.perf_counter()
            try:
                evicted = ssn.evict_bulk(chosen, "reclaim")
            except Exception:
                logger.exception("bulk reclaim failed on node %s", node.name)
                evicted = []
            engine.note_evictions(len(evicted))
            for reclaimee in evicted:
                reclaimed.add(reclaimee.resreq)
            if len(evicted) < len(chosen):
                for reclaimee in views[prefix:]:
                    if resreq.less_equal(reclaimed):
                        break
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except Exception:
                        logger.exception("failed to reclaim %s", reclaimee.uid)
                        continue
                    engine.note_evictions(1)
                    reclaimed.add(reclaimee.resreq)
            engine.phase["replay"] += time.perf_counter() - t0
            if task.init_resreq.less_equal(reclaimed):
                try:
                    ssn.pipeline(task, node.name)
                except Exception:
                    logger.exception("failed to pipeline %s on %s", task.uid, node.name)
                return True


def new() -> ReclaimAction:
    return ReclaimAction()
