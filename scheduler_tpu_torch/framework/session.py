"""The scheduling Session: one cycle's frozen world + plugin dispatch + mutations.

Reference: ``pkg/scheduler/framework/session.go`` (state + mutation ops) and
``session_plugins.go`` (tiered dispatch).  The dispatch semantics are the plugin
contract and are preserved exactly:

* ``reclaimable``/``preemptable``: per tier, *intersection* of every enabled
  plugin's victim list; first tier that produced a non-None list wins
  (session_plugins.go:100-182).
* ``job_ready``/``job_pipelined``/``job_enqueueable``: veto-AND across all tiers.
* ``job_order``/``queue_order``/``task_order``: first nonzero comparison wins;
  fallback orders by creation timestamp then UID.
* ``predicate``: error short-circuit across tiers.
* ``node_order`` family: additive across tiers.
* ``overused``: first True wins.
"""

from __future__ import annotations

import itertools
import logging
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

import numpy as np

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.queue_info import QueueInfo
from scheduler_tpu_torch.api.types import ALLOCATED_STATUSES, TaskStatus
from scheduler_tpu_torch.apis.objects import (
    PodGroupCondition,
    PodGroupPhase,
    PodGroupStatus,
    POD_GROUP_UNSCHEDULABLE_TYPE,
)
from scheduler_tpu_torch.conf import Tier
from scheduler_tpu_torch.framework.interface import Event, EventHandler, Plugin, ValidateResult

if TYPE_CHECKING:
    from scheduler_tpu_torch.cache.interface import Cache
    from scheduler_tpu_torch.framework.statement import Statement

logger = logging.getLogger("scheduler_tpu_torch.session")

_session_counter = itertools.count(1)


class _LazyTaskViews:
    """Sequence of placed task views that materializes on first access — the
    ``tasks`` argument handed to bulk allocate handlers by the columnar commit
    (builtin handlers consume only the CommitPlan and never touch it)."""

    def __init__(self, items) -> None:
        self._items = items
        self._views: Optional[list] = None

    def _materialize(self) -> list:
        views = self._views
        if views is None:
            views = self._views = [
                job.view_for_row(int(r))
                for job, rows, *_ in self._items
                for r in rows
            ]
        return views

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self) -> int:
        return sum(len(rows) for _job, rows, *_ in self._items)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __bool__(self) -> bool:
        return len(self) > 0


class Session:
    def __init__(self, cache: "Cache", tiers: Optional[List[Tier]] = None) -> None:
        self.uid: str = f"ssn-{next(_session_counter)}"
        self.cache = cache
        self.tiers: List[Tier] = tiers or []
        # Device the engines place on (``ops/device.resolve_device``: None
        # means CUDA); set by ``open_session``.
        self.device = None

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}

        self.pod_group_status: Dict[str, PodGroupStatus] = {}

        self.plugins: Dict[str, Plugin] = {}
        self.event_handlers: List[EventHandler] = []

        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.static_predicate_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, Callable] = {}
        self.batch_node_order_fns: Dict[str, Callable] = {}
        self.node_map_fns: Dict[str, Callable] = {}
        self.node_reduce_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.job_enqueueable_fns: Dict[str, Callable] = {}

        # Device-engine handles installed by plugins (device-engine extension):
        # plugins contribute mask/score tensor builders here instead of (or in
        # addition to) per-task host callbacks; actions fuse them into one kernel.
        self.device_predicates: Dict[str, Callable] = {}
        self.device_scorers: Dict[str, Callable] = {}
        self.device_score_weights: Dict[str, float] = {}
        # Plugins whose host node-order callbacks are fully represented by the
        # dynamic scorer weights above (so the device path may be used).
        self.device_weighted_plugins: set = set()
        # Dynamic (in-scan) gates a plugin turned on, e.g. "pod_count".
        self.device_dynamic_gates: set = set()
        # Queue fair-share tensors for the fused engine: plugin name ->
        # builder(queue_uids) -> {"deserved": [Q, R], "allocated": [Q, R]}
        # raw-unit numpy arrays (proportion registers this so its live queue
        # ordering + overused gating can run inside the device while-loop).
        self.device_queue_fair: Dict[str, Callable] = {}
        # Task uids whose predicates depend on placements made DURING the scan
        # (host ports, inter-pod (anti-)affinity).  Their static mask rows are
        # incomplete; actions must route the owning jobs through the exact
        # host loop while the rest of the session stays device-accelerated.
        self.device_dynamic_task_uids: set = set()
        # job uid -> job_tie_key cache (fixed at first use, see job_tie_key).
        self._job_tie_keys: Dict[str, tuple] = {}
        # The cache's node-spec generation captured AT SNAPSHOT TIME
        # (open_session); -1 = unknown (bare Session in tests).
        self.node_generation: int = -1

    # -- registration (Add*Fn) ----------------------------------------------

    def add_job_order_fn(self, name: str, fn: Callable) -> None:
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name: str, fn: Callable) -> None:
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name: str, fn: Callable) -> None:
        self.task_order_fns[name] = fn

    def add_predicate_fn(self, name: str, fn: Callable) -> None:
        self.predicate_fns[name] = fn

    def add_static_predicate_fn(self, name: str, fn: Callable) -> None:
        """The plugin's predicate MINUS its scan/state-dependent parts (pod
        count, host ports, inter-pod affinity).  A plugin that registers this
        alongside its predicate_fn promises: for tasks without dynamic
        predicates, ``predicate_fn == static_predicate_fn AND the live gates``
        — which lets preempt/reclaim memoize whole node sweeps per task
        signature (utils.sweep.SweepCache)."""
        self.static_predicate_fns[name] = fn

    def add_node_order_fn(self, name: str, fn: Callable) -> None:
        self.node_order_fns[name] = fn

    def add_batch_node_order_fn(self, name: str, fn: Callable) -> None:
        self.batch_node_order_fns[name] = fn

    def add_node_map_fn(self, name: str, fn: Callable) -> None:
        self.node_map_fns[name] = fn

    def add_node_reduce_fn(self, name: str, fn: Callable) -> None:
        self.node_reduce_fns[name] = fn

    def add_preemptable_fn(self, name: str, fn: Callable) -> None:
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name: str, fn: Callable) -> None:
        self.reclaimable_fns[name] = fn

    def add_overused_fn(self, name: str, fn: Callable) -> None:
        self.overused_fns[name] = fn

    def add_job_ready_fn(self, name: str, fn: Callable) -> None:
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name: str, fn: Callable) -> None:
        self.job_pipelined_fns[name] = fn

    def add_job_valid_fn(self, name: str, fn: Callable) -> None:
        self.job_valid_fns[name] = fn

    def add_job_enqueueable_fn(self, name: str, fn: Callable) -> None:
        self.job_enqueueable_fns[name] = fn

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    def add_device_predicate(self, name: str, builder: Callable) -> None:
        self.device_predicates[name] = builder

    def add_device_scorer(self, name: str, builder: Callable) -> None:
        self.device_scorers[name] = builder

    def add_device_queue_fair(self, name: str, builder: Callable) -> None:
        self.device_queue_fair[name] = builder

    # -- tiered dispatch ------------------------------------------------------

    def _victims(self, fns: Dict[str, Callable], enabled_key: str, subject, candidates):
        """Victim aggregation, mirroring session_plugins.go:100-182 exactly.

        Plugin fns return a list of victims or ``None`` (the Go nil slice).  The
        FIRST enabled fn anywhere initializes the victim set — even to None —
        and every later enabled fn across ALL tiers intersects into it (the
        reference's ``init`` flag outlives the tier loop); an empty intersection
        collapses back to None (Go's nil intersection slice).  After each tier,
        a non-None set decides and lower tiers are never consulted.
        """
        victims: Optional[list] = None
        init = False
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not getattr(plugin, enabled_key)():
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                cand = fn(subject, candidates)
                if not init:
                    victims = None if cand is None else list(cand)
                    init = True
                else:
                    cand_uids = {c.uid for c in (cand or [])}
                    inter = [v for v in (victims or []) if v.uid in cand_uids]
                    victims = inter if inter else None
            if victims is not None:
                return victims
        return []

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]) -> List[TaskInfo]:
        return self._victims(self.reclaimable_fns, "reclaimable_enabled", reclaimer, reclaimees)

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]) -> List[TaskInfo]:
        return self._victims(self.preemptable_fns, "preemptable_enabled", preemptor, preemptees)

    def overused(self, queue: QueueInfo) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def _veto_and(self, fns: Dict[str, Callable], enabled_key: str, obj) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not getattr(plugin, enabled_key)():
                    continue
                fn = fns.get(plugin.name)
                if fn is not None and not fn(obj):
                    return False
        return True

    def job_ready(self, job: JobInfo) -> bool:
        return self._veto_and(self.job_ready_fns, "job_ready_enabled", job)

    def job_pipelined(self, job: JobInfo) -> bool:
        return self._veto_and(self.job_pipelined_fns, "job_pipelined_enabled", job)

    def job_enqueueable(self, job: JobInfo) -> bool:
        # No enable flag for enqueueable in the reference (session_plugins.go:262-278).
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_enqueueable_fns.get(plugin.name)
                if fn is not None and not fn(job):
                    return False
        return True

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(job)
                if vr is not None and not vr.passed:
                    return vr
        return None

    def _ordered(self, fns: Dict[str, Callable], enabled_key: str, l, r) -> Optional[bool]:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not getattr(plugin, enabled_key)():
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        return None

    def job_tie_key(self, job: JobInfo) -> tuple:
        """Deterministic job-order fallback key, fixed at first use per
        session: ``(floor(creation), request-sig, selector, creation, uid)``.

        The reference's fallback is CreationTimestamp then UID
        (session_plugins.go:297-303) — and its timestamps are metav1.Time,
        WHOLE-SECOND granularity, so jobs created in the same burst second
        are an arbitrary-order tie there.  We preserve its FIFO behavior at
        that same observable granularity, and inside a tied second we order
        single-pending-task jobs by their task's request signature and node
        selector, so plugin-equal one-pod jobs (the kubemark shadow-PodGroup
        shape) sit adjacently in every engine — the fused engine then places
        whole runs of them in one device step."""
        key = self._job_tie_keys.get(job.uid)
        if key is None:
            sig = b""
            sel = ""
            pending_rows = getattr(job, "pending_rows", None)
            if pending_rows is not None:  # plugin tests may pass bare stubs
                rows = pending_rows()
                if rows.shape[0] == 1:
                    st = job.store
                    if not st.sigs_valid():
                        st.build_sigs()
                    sig = st.sigs[rows[0]]
                    # Selector in the key too: tasks with different selectors
                    # have different static mask rows, which break device
                    # runs — grouping by (request, selector) keeps run-mates
                    # adjacent.
                    pod = st.cores[rows[0]].pod
                    if pod is not None and pod.node_selector:
                        sel = repr(sorted(pod.node_selector.items()))
            ts = job.creation_timestamp
            key = (int(ts), sig, sel, ts, job.uid)
            self._job_tie_keys[job.uid] = key
        return key

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        res = self._ordered(self.job_order_fns, "job_order_enabled", l, r)
        if res is not None:
            return res
        return self.job_tie_key(l) < self.job_tie_key(r)

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        res = self._ordered(self.queue_order_fns, "queue_order_enabled", l, r)
        if res is not None:
            return res
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.task_order_enabled():
                    continue
                fn = self.task_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        # Same tie-break chain as utils.scheduler_helper.task_sort_key so heap
        # pops and sorted lists agree engine-to-engine (req-signature grouping
        # is the device run-batching enabler; see task_sort_key).
        if l.req_sig != r.req_sig:
            return l.req_sig < r.req_sig
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """Raises FitError on the first failing predicate (error short-circuit)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.predicate_enabled():
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is not None:
                    fn(task, node)  # raises on failure

    def static_predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """``predicate_fn`` over the registered STATIC predicate parts only
        (see add_static_predicate_fn); same dispatch, same error contract."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.predicate_enabled():
                    continue
                fn = self.static_predicate_fns.get(plugin.name)
                if fn is not None:
                    fn(task, node)  # raises on failure

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.node_order_enabled():
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    score += fn(task, node)
        return score

    def batch_node_order_fn(self, task: TaskInfo, nodes: List[NodeInfo]) -> Dict[str, float]:
        scores: Dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.node_order_enabled():
                    continue
                fn = self.batch_node_order_fns.get(plugin.name)
                if fn is None:
                    continue
                for node_name, s in fn(task, nodes).items():
                    scores[node_name] = scores.get(node_name, 0.0) + s
        return scores

    def node_order_map_fn(self, task: TaskInfo, node: NodeInfo):
        """(per-plugin map scores, summed order score) for one node."""
        node_score_map: Dict[str, float] = {}
        priority_score = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.node_order_enabled():
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    priority_score += fn(task, node)
                mfn = self.node_map_fns.get(plugin.name)
                if mfn is not None:
                    node_score_map[plugin.name] = mfn(task, node)
        return node_score_map, priority_score

    def node_order_reduce_fn(self, task: TaskInfo, plugin_node_scores: Dict[str, Dict[str, float]]) -> Dict[str, float]:
        node_scores: Dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not plugin.node_order_enabled():
                    continue
                rfn = self.node_reduce_fns.get(plugin.name)
                if rfn is None:
                    continue
                reduced = rfn(task, plugin_node_scores.get(plugin.name, {}))
                for host, s in reduced.items():
                    node_scores[host] = node_scores.get(host, 0.0) + s
        return node_scores

    # -- mutation ops (session.go:199-363) ------------------------------------

    def statement(self) -> "Statement":
        from scheduler_tpu_torch.framework.statement import Statement

        return Statement(self)

    def _fire_allocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def _fire_deallocate_bulk(self, tasks: List[TaskInfo]) -> None:
        events = None
        for eh in self.event_handlers:
            if eh.bulk_deallocate_func is not None:
                eh.bulk_deallocate_func(tasks)
            elif eh.deallocate_func is not None:
                if events is None:
                    events = [Event(t) for t in tasks]
                for ev in events:
                    eh.deallocate_func(ev)

    @staticmethod
    def _call_bulk_handler(fn, tasks, plan) -> None:
        """Invoke a bulk allocate handler with or without the CommitPlan,
        matched to its signature: a parameter literally named ``plan`` gets it
        by keyword; otherwise a second positional slot (or ``*args``) gets it
        positionally; otherwise the handler is plan-unaware.  Raw arity
        counting misclassifies ``(tasks, **kwargs)``; name-only checking
        breaks ``(tasks, commit_plan)`` — this covers both."""
        import inspect

        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            fn(tasks)
            return
        if "plan" in params:
            fn(tasks, plan=plan)
            return
        positional = [
            p
            for p in params.values()
            if p.kind
            in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
        ]
        var_pos = any(
            p.kind is inspect.Parameter.VAR_POSITIONAL for p in params.values()
        )
        if len(positional) >= 2 or var_pos:
            fn(tasks, plan)
        else:
            fn(tasks)

    def _fire_allocate_bulk(self, tasks: List[TaskInfo], plan=None) -> None:
        events = None
        for eh in self.event_handlers:
            if eh.bulk_allocate_func is not None:
                # Bulk handlers take the task list directly — no Event wrapper
                # per task (100k wrappers/cycle otherwise) — plus the optional
                # CommitPlan with precomputed per-job/per-queue sums.  Handlers
                # written against the original single-arg contract still work:
                # the plan is passed only if the signature accepts it.
                self._call_bulk_handler(eh.bulk_allocate_func, tasks, plan)
            elif eh.allocate_func is not None:
                if events is None:
                    events = [Event(t) for t in tasks]
                for ev in events:
                    eh.allocate_func(ev)

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Assign onto releasing resources; session-state only (session.go:199-239)."""
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Assign onto idle resources; dispatches the whole job once gang-ready
        (session.go:242-297)."""
        self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when allocating")
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._fire_allocate(task)

        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()):
                self._dispatch(t)

    def bulk_apply(self, placements: List, plan=None) -> None:
        """Commit a whole device placement at once: the batched equivalent of
        calling ``allocate``/``pipeline`` per row, with identical final state.

        ``placements`` rows are ``(task, hostname, pipelined)`` in placement
        order.  Equivalence to the sequential path (which the fused kernel
        already emulated when *choosing* the placement):

        * node/job accounting is order-independent — the same deltas sum;
        * the reference dispatches ALL Allocated tasks of a job each time an
          allocation finds the job ready (session.go:286-294); readiness is
          monotone during allocate, so "dispatch every Allocated task of every
          job that is ready after the batch" reaches the same end state;
        * event handlers fire once with the full batch (or per-event for
          handlers without a bulk form).

        ``plan`` (CommitPlan, optional) carries every ledger delta as
        precomputed dense rows — with it, no per-task resource arithmetic runs
        anywhere in the commit.
        """
        if not placements:
            return

        from collections import defaultdict

        by_job: Dict[str, List] = defaultdict(list)
        by_node: Dict[str, List[TaskInfo]] = defaultdict(list)
        for task, hostname, pipelined in placements:
            if task.job not in self.jobs:
                raise KeyError(f"failed to find job {task.job} when allocating")
            if hostname not in self.nodes:
                raise KeyError(f"failed to find node {hostname}")
            if not pipelined:
                self.cache.allocate_volumes(task, hostname)
            by_job[task.job].append((task, hostname, pipelined))
            by_node[hostname].append(task)

        job_alloc = plan.job_alloc() if plan is not None else {}
        affected: List[JobInfo] = []
        for job_uid, rows in by_job.items():
            job = self.jobs[job_uid]
            job.bulk_update_status(
                [t for t, _, p in rows if not p], TaskStatus.ALLOCATED,
                net_add=job_alloc.get(job_uid),
            )
            job.bulk_update_status([t for t, _, p in rows if p], TaskStatus.PIPELINED)
            for task, hostname, _ in rows:
                task.node_name = hostname
            affected.append(job)

        node_deltas = plan.node_deltas() if plan is not None else {}
        job_alloc_counts = plan.job_alloc_counts() if plan is not None else {}
        for hostname, tasks in by_node.items():
            self.nodes[hostname].bulk_add_tasks(tasks, agg=node_deltas.get(hostname))

        self._fire_allocate_bulk([t for t, _, _ in placements], plan)

        to_bind: List[TaskInfo] = []
        ready_uids: List[str] = []
        plan_covers_bind = plan is not None
        for job in affected:
            if self.job_ready(job):
                allocated = list(
                    job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()
                )
                # The plan's bind ledger covers exactly THIS batch's allocated
                # rows.  A ready job can also hold Allocated tasks from an
                # earlier action in the same session (e.g. backfill ordered
                # before allocate) — those are in to_bind but not in the plan,
                # so using the plan would under-account the cache ledgers.
                if plan_covers_bind and len(allocated) != job_alloc_counts.get(job.uid, 0):
                    plan_covers_bind = False
                for t in allocated:
                    self.cache.bind_volumes(t)
                job.bulk_update_status(allocated, TaskStatus.BINDING)
                to_bind.extend(allocated)
                ready_uids.append(job.uid)
        if to_bind:
            bind_plan = plan.bind_deltas(ready_uids) if plan_covers_bind else None
            self.cache.bind_bulk(to_bind, bind_plan)

    def _job_ready_fusable(self) -> bool:
        """True iff a job's post-batch readiness is PREDICTABLE from counts:
        the job_ready dispatch is vacuous or the builtin gang count compare
        (``JobInfo.ready``), and every allocate handler is bulk-capable (the
        columnar fire prefers ``bulk_allocate_func``, whose contract is the
        CommitPlan — only a per-task ``allocate_func`` walks views and could
        observe the intermediate ALLOCATED status).  BINDING is ready-counting
        (``ready_task_num``, job_info.go ReadyTaskNum), so writing a
        predicted-ready batch straight to BINDING gives every later dispatch
        the same answer as the two-step ALLOCATED -> BINDING walk."""
        if set(self.job_ready_fns) - {"gang"}:
            return False
        return all(
            eh.bulk_allocate_func is not None or eh.allocate_func is None
            for eh in self.event_handlers
        )

    def _gang_ready_live(self) -> bool:
        # Lazy import: ops.allocator pulls device modules at import time.
        from scheduler_tpu_torch.ops.allocator import gang_ready_active

        return gang_ready_active(self)

    def bulk_apply_columnar(self, items, node_batches, plan) -> None:
        """Commit a whole device placement with NO per-task Python objects:
        the columnar equivalent of ``bulk_apply`` (same final state, argued
        there), driven by job-store row indices and the CommitPlan ledgers.

        ``items``: [(job, rows, names, ids, pipe)] — placed rows per job in
        placement order, the target node name + engine node index per row,
        and the pipelined mask.
        ``node_batches``: node name -> [(cores, status)] deferred node-side
        task records grouped by the engine.
        """
        if not items:
            return

        from scheduler_tpu_torch.api.types import TaskStatus as TS

        job_alloc = plan.job_alloc()
        alloc_counts = plan.job_alloc_counts()
        fuse_ok = self._job_ready_fusable()
        gang_live = self._gang_ready_live() if fuse_ok else False

        from scheduler_tpu_torch.api.job_info import batch_update_status_rows

        to_bind = []  # (job, rows, ids) — BINDING rows for the cache dispatch
        ready_uids: List[str] = []
        plan_covers_bind = True
        deferred: List = []  # jobs whose readiness needs the full dispatch
        status_batch: List = []  # (job, rows, to, net, from) — ONE native pass
        for job, rows, names, ids, pipe in items:
            if len(rows) == 0:
                continue
            alloc_rows = rows[~pipe]
            pipe_rows = rows[pipe]
            self.cache.allocate_volumes_rows(job, alloc_rows, names[~pipe])
            net = job_alloc.get(job.uid)
            # Ready fusion: a fresh batch on a predictably-ready job goes
            # straight to BINDING — one status pass instead of two.  Only
            # when no ALLOCATED rows predate the batch (so the bind ledger
            # provably covers exactly these rows).
            fused = (
                fuse_ok
                and alloc_rows.shape[0] > 0
                and job.status_count(TS.ALLOCATED) == 0
                and (
                    not gang_live
                    or job.ready_task_num() + alloc_rows.shape[0] >= job.min_available
                )
            )
            if fused:
                self.cache.bind_volumes_rows(job, alloc_rows)
                status_batch.append((job, alloc_rows, TS.BINDING, net, TS.PENDING))
                to_bind.append((job, alloc_rows, ids[~pipe]))
                ready_uids.append(job.uid)
            else:
                status_batch.append((job, alloc_rows, TS.ALLOCATED, net, TS.PENDING))
                deferred.append((job, rows, ids, pipe))
            status_batch.append((job, pipe_rows, TS.PIPELINED, None, TS.PENDING))
            job.set_node_names_rows(rows, names)
        # Each job's fused/deferred decision reads only ITS OWN counts, so
        # deferring every status write to one batched pass is safe — and the
        # pass is one native scatter instead of ~2 numpy calls per job.
        batch_update_status_rows(status_batch)

        node_deltas = plan.node_deltas()
        nodes = self.nodes
        ledger = getattr(nodes, "ledger", None)
        vectorized = False
        if ledger is not None and node_batches:
            # Vectorized node commit: ONE ledger scatter for every touched
            # node's arithmetic, batch RECORDS stashed without materializing
            # views.  Mirrors add_deferred_batches exactly; placeholder
            # nodes (no spec: accounting skipped on the object path) fall
            # back wholesale.
            names = list(node_batches)
            rows = [ledger.row_of.get(nm) for nm in names]
            if all(r is not None for r in rows) and all(
                nodes.node_spec(nm) is not None for nm in names
            ):
                idle_sub = np.stack([node_deltas[nm][0] for nm in names])
                rel_sub = np.stack([node_deltas[nm][1] for nm in names])
                used_add = np.stack([node_deltas[nm][2] for nm in names])
                counts = np.asarray(
                    [node_deltas[nm][3] + node_deltas[nm][4] for nm in names],
                    dtype=np.int64,
                )
                ledger.apply_node_deltas(
                    np.asarray(rows, dtype=np.int64),
                    idle_sub, rel_sub, used_add, counts,
                    mins=self.cache.vocab.min_thresholds(),
                )
                for node_name, batches in node_batches.items():
                    nodes.stash_batch_records(node_name, batches)
                vectorized = True
        if not vectorized:
            for node_name, batches in node_batches.items():
                node = nodes.get(node_name)
                if node is None:
                    raise KeyError(f"failed to find node {node_name}")
                node.add_deferred_batches(batches, node_deltas[node_name])

        self._fire_allocate_bulk_columnar(items, plan)

        for job, rows, ids, pipe in deferred:
            if self.job_ready(job):
                alloc_rows = job.rows_with_status(TS.ALLOCATED)
                # The plan's bind ledger covers exactly THIS batch's allocated
                # rows; Allocated tasks left by an earlier action in the same
                # session would under-account it (see bulk_apply).
                if alloc_rows.shape[0] != alloc_counts.get(job.uid, 0):
                    plan_covers_bind = False
                self.cache.bind_volumes_rows(job, alloc_rows)
                job.bulk_update_status_rows(
                    alloc_rows, TS.BINDING, assume_unique=True,
                    assume_from=TS.ALLOCATED,
                )
                if plan_covers_bind:
                    # alloc_rows == this batch's allocated rows (count match +
                    # engine uniqueness): recover their engine node ids via a
                    # row->id scatter over the batch.
                    id_of = np.full(int(rows.max()) + 1, -1, dtype=np.int32)
                    id_of[rows] = ids
                    to_bind.append((job, alloc_rows, id_of[alloc_rows]))
                else:
                    to_bind.append((job, alloc_rows, None))
                ready_uids.append(job.uid)
        if to_bind:
            if plan_covers_bind:
                self.cache.bind_bulk_columnar(to_bind, plan.bind_deltas(ready_uids))
            else:
                tasks = [
                    job.view_for_row(int(r)) for job, rows, _ids in to_bind for r in rows
                ]
                self.cache.bind_bulk(tasks, None)

    def _fire_allocate_bulk_columnar(self, items, plan) -> None:
        """Event fan-out for the columnar commit.  Builtin bulk handlers
        consume only the plan; the tasks argument is a LAZY sequence that
        materializes views only if a handler actually touches it, so handlers
        reading both tasks and plan keep the object-path contract."""
        lazy = _LazyTaskViews(items)
        for eh in self.event_handlers:
            if eh.bulk_allocate_func is not None:
                self._call_bulk_handler(eh.bulk_allocate_func, lazy, plan)
            elif eh.allocate_func is not None:
                for t in lazy:
                    eh.allocate_func(Event(t))

    def _dispatch(self, task: TaskInfo) -> None:
        """Bind an allocated task through the cache (session.go:299-323)."""
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when dispatching")
        job.update_task_status(task, TaskStatus.BINDING)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Evict through the cache immediately (session.go:326-363)."""
        self.cache.evict(reclaimee, reason)
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job} when evicting")
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self._fire_deallocate(reclaimee)

    def evict_bulk(self, reclaimees: List[TaskInfo], reason: str) -> List[TaskInfo]:
        """Batched ``evict``: same final state as the per-task loop, with the
        bookkeeping vectorized per commit — the eviction analogue of the
        columnar bind path (per-victim bookkeeping would make reclaim latency
        track eviction volume).

        Per batch: ONE cache call (grouped status writes + node ledger
        arithmetic + chunked RPC dispatch), per-job status-row updates, one
        releasing-add per touched node, and one bulk deallocate event.
        Returns the tasks whose cache eviction was ACCEPTED (sync-mode
        failures are excluded and left untouched, like the loop's
        per-victim try/except)."""
        if not reclaimees:
            return []
        accepted = self.cache.evict_bulk(reclaimees, reason)
        if not accepted:
            return []
        # Per-group guards replace the old loop's per-victim try/except: a
        # session-side inconsistency (job gone mid-action) must log and move
        # on — the cache ALREADY committed these evictions, so aborting here
        # would diverge session from cache for the rest of the action.
        by_job: Dict[str, List[TaskInfo]] = {}
        by_node: Dict[str, List[TaskInfo]] = {}
        for t in accepted:
            by_job.setdefault(t.job, []).append(t)
            if t.node_name:
                by_node.setdefault(t.node_name, []).append(t)
        for job_uid, ts in by_job.items():
            job = self.jobs.get(job_uid)
            if job is None:
                logger.error("failed to find job %s when evicting", job_uid)
                continue
            try:
                rows = np.asarray(
                    [job.store.row_of[t.uid] for t in ts], dtype=np.int64
                )
                job.bulk_update_status_rows(
                    rows, TaskStatus.RELEASING, assume_from=TaskStatus.RUNNING
                )
            except Exception:
                logger.exception("bulk evict status write failed for %s", job_uid)
                continue
            for t in ts:  # detached caller clones track the move too
                t.status = TaskStatus.RELEASING
        for node_name, ts in by_node.items():
            node = self.nodes.get(node_name)
            if node is None:
                continue
            try:
                node.bulk_release_tasks(ts)
            except Exception:
                logger.exception("bulk release failed on node %s", node_name)
        self._fire_deallocate_bulk(accepted)
        return accepted

    def update_job_condition(self, job_info: JobInfo, cond: PodGroupCondition) -> None:
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(f"failed to find job {job_info.namespace}/{job_info.name}")
        conds = job.pod_group.status.conditions
        for i, c in enumerate(conds):
            if c.type == cond.type:
                conds[i] = cond
                return
        conds.append(cond)


def job_status(ssn: Session, job: JobInfo) -> PodGroupStatus:
    """Recompute a job's PodGroup status at session close (session.go:151-189).
    Pure count arithmetic — never materializes task objects."""
    status = job.pod_group.status

    unschedulable = any(
        c.type == POD_GROUP_UNSCHEDULABLE_TYPE
        and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions
    )

    if job.status_count(TaskStatus.RUNNING) and unschedulable:
        status.phase = PodGroupPhase.UNKNOWN
    else:
        allocated = sum(job.status_count(st) for st in ALLOCATED_STATUSES)
        if allocated >= job.pod_group.min_member:
            status.phase = PodGroupPhase.RUNNING
        elif job.pod_group.status.phase != PodGroupPhase.INQUEUE:
            status.phase = PodGroupPhase.PENDING

    status.running = job.status_count(TaskStatus.RUNNING)
    status.failed = job.status_count(TaskStatus.FAILED)
    status.succeeded = job.status_count(TaskStatus.SUCCEEDED)
    return status
