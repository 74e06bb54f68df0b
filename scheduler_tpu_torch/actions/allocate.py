"""Allocate: the main scheduling pass (reference ``actions/allocate/allocate.go``).

Control flow preserved from the reference: queues and jobs pop through live
priority heaps (so DRF share updates reorder between pops), a job pop places
tasks until the first infeasible task (job leaves the rotation, fit errors
recorded) or until the gang goes ready (job re-queued), and the queue is
re-pushed after every pop.

The action runs in one of three routes, chosen as the JAX package chooses:

* **fused** (every plugin device-capable, ``FusedAllocator.supported``): the
  whole action — job selection and every task placement — runs on the
  session's device as one launch of the mega kernel (``ops/megakernel.py``)
  or, where its gate closes, as the ``fused_allocate`` loop with one
  placement-step launch a step (``ops/fused.py``); one result array, one
  columnar commit.
* **device** (the fused gate declines — static ``[T, N]`` rows past
  ``SCHEDULER_TORCH_FUSED_STATIC_LIMIT`` — but every plugin is
  device-capable, ``DeviceAllocator.supported``): the host heaps pop the
  jobs, and each job pop's task loop is one launch of the placement scan
  (``ops/allocator.py``, ``ops/placement.py``), node state resident on the
  device across pops; placements commit per task.
* **host**: the reference's per-task predicate/prioritize/select sweep
  using the session's host callbacks — the reference semantics, taken for
  the sessions neither engine takes (and for scan-dynamic jobs).

All apply results through the session so event handlers, gang dispatch and
cache bind semantics are identical.  ``routes`` counts how often each route
ran.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Dict, List

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.api.unschedule_info import FitError, FitErrors, NODE_RESOURCE_FIT_FAILED
from scheduler_tpu_torch.apis.objects import PodGroupPhase
from scheduler_tpu_torch.framework.interface import Action
from scheduler_tpu_torch.utils.priority_queue import PriorityQueue
from scheduler_tpu_torch.utils.scheduler_helper import (
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    select_best_node,
    task_sort_key,
)

logger = logging.getLogger("scheduler_tpu_torch.actions.allocate")

# Route counters: how many times each route ran (plain integers).
routes = {"fused": 0, "device": 0, "host": 0}


def _inversion_queues(ssn, static_jobs: List[JobInfo], dynamic_jobs: List[JobInfo]) -> set:
    """Queues where static-first could hand resources to a lower-ranked job:
    the queue holds a dynamic job that the session job order ranks AHEAD of
    one of its static jobs.  Within-queue order is the reference's primary
    dispensing key; cross-queue rotation is share-driven and self-correcting,
    so this is the pair the deviation can actually flip.  Returning the SET
    (not a bool) bounds the exact-order fallback to the queues that need it
    — an inversion in one queue must not demote every other queue's tasks
    to the host loop.  O(jobs) comparator calls, and only on cycles with
    dynamic jobs."""
    best_dynamic: dict = {}
    order = ssn.job_order_fn
    for d in dynamic_jobs:
        cur = best_dynamic.get(d.queue)
        if cur is None or order(d, cur):
            best_dynamic[d.queue] = d
    inverted: set = set()
    if not best_dynamic:
        return inverted
    for s in static_jobs:
        if s.queue in inverted:
            continue
        d = best_dynamic.get(s.queue)
        if d is not None and order(d, s):
            inverted.add(s.queue)
    return inverted


def collect_candidates(ssn) -> List[JobInfo]:
    """Jobs eligible for this allocate pass (the allocate.go:49-72 filter):
    skip PodGroup-Pending jobs, JobValid vetoes, and jobs whose queue is gone."""
    candidates: List[JobInfo] = []
    for job in ssn.jobs.values():
        if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            logger.debug("job %s skips allocate: %s", job.uid, vr.message)
            continue
        if job.queue not in ssn.queues:
            logger.warning("skip job %s: queue %s not found", job.uid, job.queue)
            continue
        candidates.append(job)
    return candidates


def split_dynamic(ssn, candidates: List[JobInfo]) -> tuple:
    """Partition jobs by scan-dynamic predicate use (host ports / inter-pod
    affinity, published per-task by the predicates plugin).  A job with ANY
    dynamic pending task runs entirely through the exact host loop — gang
    arithmetic stays whole-job — while every other job keeps the device
    engines.  Jobs with volume claims take the host loop too when a real
    VolumeBinder is configured: an AllocateVolumes failure must fail only
    that task's placement (reference session.go:242-247), which the batched
    commit paths cannot express.  Returns ``(static_jobs, dynamic_jobs)``."""
    dyn_uids = ssn.device_dynamic_task_uids
    volumes_live = not getattr(ssn.cache.volume_binder, "NOOP", False)
    if not dyn_uids and not volumes_live:
        return candidates, []
    static_jobs: List[JobInfo] = []
    dynamic_jobs: List[JobInfo] = []
    for job in candidates:
        # Columnar check — materializing task views here would cost O(tasks)
        # Python objects per cycle, defeating the very fast path this split
        # protects.  pending_rows() already excludes BestEffort rows, so a
        # dynamic-but-empty-request task cannot de-accelerate (backfill owns
        # those on the host path regardless).
        if volumes_live and job.volume_claim_tasks:
            dynamic_jobs.append(job)
            continue
        # The rows/uids fancy-indexing only pays off when there ARE dynamic
        # uids to intersect — with a real VolumeBinder installed (every
        # connector deployment) this loop runs even when dyn_uids is empty,
        # and the O(1) volume_claim_tasks check above is all those jobs need.
        if dyn_uids:
            rows = job.pending_rows()
            if rows.shape[0] and dyn_uids.intersection(job.store.uids[rows]):
                dynamic_jobs.append(job)
                continue
        static_jobs.append(job)
    return static_jobs, dynamic_jobs


def record_fused_failures(failures) -> None:
    """Record first-infeasible rows as FitErrors on their jobs — the single
    owner of the 'failed placement row -> FitErrors' convention for columnar
    results (``failures`` = [(job, row)] from ``FusedAllocator.run_columnar``)."""
    for job, row in failures:
        core = job.store.cores[row]
        fe = FitErrors()
        fe.set_node_error("*", FitError(core.name, "*", NODE_RESOURCE_FIT_FAILED))
        job.nodes_fit_errors[core.uid] = fe



class AllocateAction(Action):
    def name(self) -> str:
        return "allocate"

    def execute(self, ssn) -> None:
        candidates = collect_candidates(ssn)
        if not candidates:
            return
        from scheduler_tpu_torch.ops.allocator import DeviceAllocator
        from scheduler_tpu_torch.ops.fused import FusedAllocator

        # Jobs with scan-dynamic predicates (host ports / pod affinity) can
        # only run on the exact host loop; everything else may use the fused
        # route.  The fused pass runs FIRST, then the dynamic jobs place
        # against the node state it committed (the JAX package's deviation
        # from the reference's single interleaved job order, bounded to the
        # dynamic jobs): a queue where that could invert the job order
        # (``_inversion_queues``) sends all its jobs to the host loop.
        static_jobs, dynamic_jobs = split_dynamic(ssn, candidates)
        if dynamic_jobs and static_jobs:
            bad = _inversion_queues(ssn, static_jobs, dynamic_jobs)
            if bad:
                demoted = [j for j in static_jobs if j.queue in bad]
                static_jobs = [j for j in static_jobs if j.queue not in bad]
                dynamic_jobs = demoted + dynamic_jobs
        if FusedAllocator.supported(ssn, static_jobs):
            if static_jobs:
                self._run_fused(ssn, static_jobs)
            if not dynamic_jobs:
                return
            candidates = dynamic_jobs
        elif static_jobs and DeviceAllocator.supported(ssn):
            self._run_device(ssn, static_jobs)
            if not dynamic_jobs:
                return
            candidates = dynamic_jobs
        self._heap_loop(ssn, candidates)

    def _heap_loop(self, ssn, candidates: List[JobInfo], engine=None) -> None:
        routes["host" if engine is None else "device"] += 1
        queues = PriorityQueue(ssn.queue_order_fn)
        jobs_map: Dict[str, PriorityQueue] = {}
        for job in candidates:
            # One heap entry per queue. The reference pushes one copy per job
            # (allocate.go:58-63); with a live comparator (proportion shares
            # mutate between pops) the stale duplicate copies make pop order
            # heap-implementation-defined.  A single copy pins the intended
            # semantic — pop the least-share queue — and keeps the heap
            # consistent: the only key that mutates belongs to the queue
            # currently outside the heap (it re-sifts on re-push).  The
            # rotation is driven by the re-push after every job pop instead.
            if job.queue not in jobs_map:
                queues.push(ssn.queues[job.queue])
                jobs_map[job.queue] = PriorityQueue(ssn.job_order_fn)
            jobs_map[job.queue].push(job)

        logger.debug("allocating over %d queues", len(jobs_map))

        # The host pops keep the reference's per-job task heap; the device
        # pops a sorted deque (the scan consumes tasks strictly in task
        # order, and repeated pops of a gang-ready job would otherwise
        # drain and re-push the whole heap each time).
        pending_tasks: Dict[str, PriorityQueue] = {}
        ordered_pending: Dict[str, deque] = {}
        # Node views are materialized at the first host pop only.
        all_nodes: List = []
        all_nodes_ready = False

        def host_predicate(task: TaskInfo, node) -> None:
            # Resource pre-predicate: fits idle OR releasing (allocate.go:80-93).
            if not task.init_resreq.less_equal(node.idle) and not task.init_resreq.less_equal(
                node.releasing
            ):
                raise FitError(task.name, node.name, NODE_RESOURCE_FIT_FAILED)
            ssn.predicate_fn(task, node)

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                logger.debug("queue %s is overused, skipping", queue.name)
                continue

            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue

            job = jobs.pop()
            if engine is not None:
                if job.uid not in ordered_pending:
                    eligible = [
                        t
                        for t in job.task_status_index.get(TaskStatus.PENDING, {}).values()
                        if not t.resreq.is_empty()  # BestEffort handled by backfill
                    ]
                    eligible.sort(key=task_sort_key(ssn))
                    ordered_pending[job.uid] = deque(eligible)
                self._run_device_pop(ssn, engine, job, ordered_pending[job.uid], jobs)
                queues.push(queue)
                continue
            if job.uid not in pending_tasks:
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(TaskStatus.PENDING, {}).values():
                    if task.resreq.is_empty():
                        continue
                    tasks.push(task)
                pending_tasks[job.uid] = tasks
            if not all_nodes_ready:
                all_nodes = get_node_list(ssn.nodes)
                all_nodes_ready = True
            self._run_host_pop(ssn, job, pending_tasks[job.uid], jobs, all_nodes, host_predicate)

            queues.push(queue)

    # -- fused route -----------------------------------------------------------

    def _run_fused(self, ssn, candidates: List[JobInfo]) -> None:
        from scheduler_tpu_torch.ops import engine_cache
        from scheduler_tpu_torch.utils import phases

        routes["fused"] += 1
        with phases.phase("engine_init"):
            # The resident engine across cycles: a steady cycle refreshes the
            # cached engine's node state instead of rebuilding it, and a hit
            # starts the run while the host rebinds (ops/engine_cache.py).
            engine, cache_status = engine_cache.get_engine(
                ssn, candidates, eager_dispatch=True
            )
        phases.note("engine_cache", cache_status)
        with phases.phase("dispatch"):
            # mega: non-blocking launch; loop: the whole loop; a no-op where
            # the hit already dispatched.
            engine.dispatch()
        with phases.phase("device"):
            engine.readback()  # blocking collect of the codes
        # Engine evidence: the engine, cohorts seen by the build, loop steps,
        # tasks per step, chunk placements or the step kernel's time.
        phases.note("cohort", engine.run_stats())
        with phases.phase("decode"):
            items, node_batches, failures = engine.run_columnar()
        with phases.phase("apply"):
            record_fused_failures(failures)
            ssn.bulk_apply_columnar(items, node_batches, engine.commit_plan())

    # -- device route ----------------------------------------------------------

    def _run_device(self, ssn, candidates: List[JobInfo]) -> None:
        from scheduler_tpu_torch.ops.allocator import DeviceAllocator
        from scheduler_tpu_torch.utils import phases

        with phases.phase("engine_init"):
            engine = DeviceAllocator(ssn, candidates)
        with phases.phase("device_pops"):
            self._heap_loop(ssn, candidates, engine)
        phases.note("device_pops", engine.run_stats())

    def _run_device_pop(self, ssn, engine, job: JobInfo, pending: deque,
                        jobs: PriorityQueue) -> None:
        if not pending:
            return

        # The engine scans the ordered tail (one task where the gang is
        # already ready) and returns the rows it processed.
        rows = engine.place_job(job, list(pending))
        if rows is None:
            # Unknown job_ready semantics — shouldn't happen with builtins.
            logger.warning("device engine refused job %s; tasks left pending", job.uid)
            return

        consumed = 0
        requeue_job = False
        for task, node_name, pipelined, failed in rows:
            consumed += 1
            if failed:
                fe = FitErrors()
                fe.set_node_error("*", FitError(task.name, "*", NODE_RESOURCE_FIT_FAILED))
                job.nodes_fit_errors[task.uid] = fe
                break
            if pipelined:
                ssn.pipeline(task, node_name)
            else:
                ssn.allocate(task, node_name)
            # The reference checks JobReady after every placement, pipeline
            # or allocate (allocate.go:184-187).
            if ssn.job_ready(job):
                requeue_job = True
                break

        for _ in range(consumed):
            pending.popleft()
        if requeue_job:
            jobs.push(job)

    # -- host engine ----------------------------------------------------------

    def _run_host_pop(self, ssn, job, tasks, jobs, all_nodes, predicate) -> None:
        while not tasks.empty():
            task = tasks.pop()

            if job.nodes_fit_delta:
                job.nodes_fit_delta = {}

            passing, fit_errors = predicate_nodes(task, all_nodes, predicate)
            if not passing:
                job.nodes_fit_errors[task.uid] = fit_errors
                break

            node_scores = prioritize_nodes(
                task,
                passing,
                ssn.batch_node_order_fn,
                ssn.node_order_map_fn,
                ssn.node_order_reduce_fn,
            )
            node = select_best_node(node_scores)

            # A failed ssn.allocate fails THIS task only — log and move on,
            # the reference's per-task error handling (allocate.go:169-175).
            # Two distinct failure points, both healed the same way:
            # AllocateVolumes raises BEFORE any session mutation (the task
            # simply stays Pending); a gang-dispatch error raises mid-job
            # exactly like the reference's dispatch loop returning err
            # (session.go:286-294) — already-bound siblings stand, the rest
            # stay Allocated in this session clone only, and the next cycle's
            # snapshot (built from cache truth) retries them.
            try:
                if task.init_resreq.less_equal(node.idle):
                    ssn.allocate(task, node.name)
                else:
                    delta = node.idle.clone()
                    delta.fit_delta(task.init_resreq)
                    job.nodes_fit_delta[node.name] = delta
                    if task.init_resreq.less_equal(node.releasing):
                        ssn.pipeline(task, node.name)
            except Exception:
                logger.exception(
                    "placement of task %s on %s failed; retried next cycle",
                    task.uid, node.name,
                )
                continue

            if ssn.job_ready(job):
                jobs.push(job)
                break


def new() -> AllocateAction:
    return AllocateAction()
