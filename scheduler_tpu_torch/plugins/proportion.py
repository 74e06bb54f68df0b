"""Proportion plugin: weighted fair queue shares by iterative water-filling
(reference ``plugins/proportion/proportion.go``).

Each round splits the remaining cluster capacity across unmet queues by weight;
a queue whose deserved share covers its request is capped at the request and
leaves the pool.  Registers queue order (lower share first), Reclaimable (victim
ok if its queue stays >= deserved), Overused, JobEnqueueable (queue capability
quota), and share-tracking event handlers.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.queue_info import QueueInfo
from scheduler_tpu_torch.api.resource import ResourceVec, le_mask, res_min, share as share_fn
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import EventHandler, Plugin
from scheduler_tpu_torch.utils.assertions import assert_that

logger = logging.getLogger("scheduler_tpu_torch.plugins.proportion")


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved", "allocated", "request")

    def __init__(self, queue: QueueInfo, vocab) -> None:
        self.queue_id = queue.uid
        self.name = queue.name
        self.weight = queue.weight
        self.share = 0.0
        self.deserved = ResourceVec.empty(vocab)
        self.allocated = ResourceVec.empty(vocab)
        self.request = ResourceVec.empty(vocab)


class ProportionPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.total_resource: Optional[ResourceVec] = None
        self.queue_attrs: Dict[str, _QueueAttr] = {}
        self._qfair_evidence: Dict[str, object] = {}

    def name(self) -> str:
        return "proportion"

    def _update_share(self, attr: _QueueAttr) -> None:
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share_fn(attr.allocated.get(rn), attr.deserved.get(rn))
            if s > res:
                res = s
        attr.share = res

    def solve_inputs(self, vocab):
        """The water-fill's operands in the queue attributes' order, as
        ``ops/qfair.solve_deserved`` takes them: weights, requests, the
        pool, the requests' and the pool's scalar-map presence, epsilons."""
        attrs = list(self.queue_attrs.values())
        return (
            np.asarray([a.weight for a in attrs], dtype=np.float64),
            np.stack([a.request.array.copy() for a in attrs]),
            self.total_resource.array.copy(),
            np.asarray([a.request.has_scalars for a in attrs], dtype=bool),
            self.total_resource.has_scalars,
            vocab.min_thresholds().astype(np.float64),
        )

    def _solve_device(self, vocab, device) -> Dict[str, object]:
        """Run the deserved water-fill on ``device`` (the session's: None is
        the card; ``ops/qfair.py``: one
        launch of the ``qfair_solve`` kernel on the card) and apply the
        solved rows and shares to the queue attributes.  Returns the evidence
        block; ``flavor`` stays ``host`` when the kill-switch is set or the
        round budget ran out (the caller then runs the host loop: host cost,
        the same shares either way)."""
        import time as _time

        from scheduler_tpu_torch.ops import qfair as _qfair

        if _qfair.qfair_flavor() != "device":
            return {"flavor": "host"}
        attrs = list(self.queue_attrs.values())
        if not attrs:
            return {"flavor": "device", "iterations": 0, "converged_at": 0,
                    "solve_ms": 0.0}
        from scheduler_tpu_torch.ops.mesh import get_mesh

        # On a node mesh the solve runs once on its first device
        # (scheduler_tpu/plugins/proportion.py:77-87).
        t0 = _time.perf_counter()
        solved = _qfair.solve_deserved(*self.solve_inputs(vocab), device=device,
                                       mesh=get_mesh())
        wall = (_time.perf_counter() - t0) * 1000.0
        if not solved["converged"]:
            logger.warning(
                "qfair device solve did not converge in %d rounds; "
                "falling back to the host water-fill",
                solved["iterations"],
            )
            return {"flavor": "host", "fallback": "not converged",
                    "iterations": solved["iterations"],
                    "device_solve_ms": round(wall, 3)}
        shares = _qfair.shares_host(
            solved["deserved"],
            np.stack([a.allocated.array.copy() for a in attrs]),
        )
        for i, attr in enumerate(attrs):
            attr.deserved = ResourceVec(vocab, solved["deserved"][i].copy())
            attr.share = float(shares[i])
        return {
            "flavor": "device",
            "iterations": solved["iterations"],
            "converged_at": solved["converged_at"],
            "solve_ms": round(wall, 3),
        }

    def _solve_host(self, vocab) -> None:
        """The reference water-filling loop (proportion.go:101-154): the
        ``SCHEDULER_TORCH_QFAIR=host`` kill-switch, the fallback of a device
        solve whose round budget ran out, and the oracle the device solve is
        held to."""
        import time as _time

        t0 = _time.perf_counter()
        remaining = self.total_resource.clone()
        meet: set = set()
        while True:
            total_weight = sum(
                attr.weight for attr in self.queue_attrs.values() if attr.queue_id not in meet
            )
            if total_weight == 0:
                break

            increased = ResourceVec.empty(vocab)
            decreased = ResourceVec.empty(vocab)
            for attr in self.queue_attrs.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(remaining.clone().multi(attr.weight / total_weight))
                if attr.request.less(attr.deserved):
                    attr.deserved = res_min(attr.deserved, attr.request)
                    meet.add(attr.queue_id)
                self._update_share(attr)
                inc, dec = attr.deserved.diff(old_deserved)
                increased.add(inc)
                decreased.add(dec)

            remaining.sub(increased).add(decreased)
            if remaining.is_empty():
                break
        self._qfair_evidence.setdefault("flavor", "host")
        self._qfair_evidence["solve_ms"] = round(
            (_time.perf_counter() - t0) * 1000.0, 3
        )

    def on_session_open(self, ssn) -> None:
        if not ssn.jobs:
            return
        vocab = next(iter(ssn.jobs.values())).vocab
        self.total_resource = ResourceVec.empty(vocab)
        ledger = getattr(ssn.nodes, "ledger", None)
        if ledger is not None:
            # Ledger-backed map: one column sum, zero node materializations.
            if ledger.r < vocab.size:
                ledger.widen(vocab.size)
            self.total_resource.add_array(
                ledger.total_allocatable()[: vocab.size],
                ledger.any_alloc_scalars(),  # map presence survives zeros
            )
        else:
            for node in ssn.nodes.values():
                self.total_resource.add(node.allocatable)

        # Build per-queue aggregates: allocated comes from the maintained job
        # aggregate (same source the fused engine seeds its device tensors
        # with — see drf.on_session_open), pending from one columnar status
        # fold (only jobs in the allocation working set pay O(tasks)).
        for job in ssn.jobs.values():
            if job.queue not in self.queue_attrs:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                self.queue_attrs[job.queue] = _QueueAttr(queue, vocab)
            attr = self.queue_attrs[job.queue]
            attr.allocated.add(job.allocated)
            attr.request.add(job.allocated)
            if job.status_count(TaskStatus.PENDING):
                attr.request.add_array(*job.status_sum((TaskStatus.PENDING,)))

        # Deserved fixed point: the device water-fill (ops/qfair.py: one
        # kernel launch, bit for bit the host loop's result) or the host loop
        # (``SCHEDULER_TORCH_QFAIR=host``, the kill-switch; also the fallback
        # when the round budget ran out).  The evidence block rides the
        # device_queue_fair seam into FusedAllocator.run_stats()["qfair"].
        self._qfair_evidence = self._solve_device(vocab, ssn.device)
        if self._qfair_evidence.get("flavor") != "device":
            self._solve_host(vocab)

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            ls = self.queue_attrs[l.uid].share
            rs = self.queue_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.name(), queue_order_fn)

        def device_queue_fair(queue_uids):
            """Raw-unit [Q, R] deserved/allocated matrices for the fused engine.

            Queues with no jobs this session have no attr; their rows stay zero
            and the kernel's share/overused math degenerates to share 0 /
            not-overused — but such queues also hold no eligible jobs, so they
            are never selected.  The ``qfair`` key carries the water-fill
            evidence block (flavor, solve wall, iterations) along the same
            seam, so the engine's run_stats can publish it without a second
            plugin round-trip.
            """
            q = len(queue_uids)
            r = vocab.size
            deserved = np.zeros((q, r), dtype=np.float64)
            allocated = np.zeros((q, r), dtype=np.float64)
            for i, uid in enumerate(queue_uids):
                attr = self.queue_attrs.get(uid)
                if attr is None:
                    continue
                deserved[i] = attr.deserved.array
                allocated[i] = attr.allocated.array
            return {
                "deserved": deserved,
                "allocated": allocated,
                "qfair": dict(self._qfair_evidence),
            }

        ssn.add_device_queue_fair(self.name(), device_queue_fair)

        def _reclaimable_seq(reclaimees, accept):
            """The reference walk (proportion.go reclaimableFn): per victim,
            skip when queue allocated is ``less`` than its request, subtract,
            accept while deserved <= remaining.  Fills ``accept`` by index."""
            allocations: Dict[str, ResourceVec] = {}
            for i, reclaimee in enumerate(reclaimees):
                job = ssn.jobs[reclaimee.job]
                attr = self.queue_attrs[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    logger.debug(
                        "not enough resource to reclaim %s from queue %s",
                        reclaimee.uid, job.queue,
                    )
                    continue
                allocated.sub(reclaimee.resreq)
                accept[i] = attr.deserved.less_equal(allocated)

        def reclaimable_fn(reclaimer: TaskInfo, reclaimees):
            if not reclaimees:
                return None
            accept = [False] * len(reclaimees)
            # Columnar fast path: group by queue; with no scalar maps in
            # play the ``allocated.less(resreq)`` skip branch is unreachable
            # (both-maps-nil => less is False, resource.py docstring), so
            # the cumulative remaining is a sequential difference chain —
            # ONE ``np.add.accumulate`` reproduces the loop's exact
            # (((a0 - r1) - r2) ...) float arithmetic, and the epsilon
            # compare vectorizes.  Scalar-bearing groups take the walk.
            by_queue: Dict[str, list] = {}
            for i, t in enumerate(reclaimees):
                by_queue.setdefault(ssn.jobs[t.job].queue, []).append(i)
            mins = vocab.min_thresholds()[None, :]
            for queue_uid, idxs in by_queue.items():
                attr = self.queue_attrs[queue_uid]
                group = [reclaimees[i] for i in idxs]
                if attr.allocated.has_scalars or any(
                    t.resreq.has_scalars for t in group
                ):
                    sub_accept = [False] * len(group)
                    _reclaimable_seq(group, sub_accept)
                    for i, ok in zip(idxs, sub_accept):
                        accept[i] = ok
                    continue
                alloc0 = attr.allocated.array
                reqs = np.stack([t.resreq.array for t in group])
                chain = np.add.accumulate(
                    np.concatenate([alloc0[None, :], -reqs]), axis=0
                )[1:]
                # The walk's per-step ``sub`` sufficiency assert, vectorized
                # (pre-subtraction state = chain + own request).
                pre = chain + reqs
                assert_that(
                    bool(np.all(le_mask(reqs, pre, mins))),
                    "resource is not sufficient for reclaim walk",
                )
                d = attr.deserved.array[None, :]
                ok = le_mask(np.broadcast_to(d, chain.shape), chain, mins)
                for i, o in zip(idxs, ok.tolist()):
                    accept[i] = bool(o)
            if not any(accept):
                return None
            return [t for t, ok in zip(reclaimees, accept) if ok]

        ssn.add_reclaimable_fn(self.name(), reclaimable_fn)

        def overused_fn(queue: QueueInfo) -> bool:
            attr = self.queue_attrs[queue.uid]
            overused = attr.deserved.less_equal(attr.allocated)
            if overused:
                logger.debug("queue %s overused: deserved <%s> allocated <%s>",
                             queue.name, attr.deserved, attr.allocated)
            return overused

        ssn.add_overused_fn(self.name(), overused_fn)

        def job_enqueueable_fn(job) -> bool:
            queue = ssn.queues.get(job.queue)
            attr = self.queue_attrs.get(job.queue)
            if queue is None or attr is None:
                return True
            # No capability set -> always enqueue (proportion.go:216-227).
            if not queue.queue.capability:
                return True
            if job.pod_group is None or job.pod_group.min_resources is None:
                return True
            pg_resource = ResourceVec.from_dict(job.pod_group.min_resources, vocab)
            capability = ResourceVec.from_dict(queue.queue.capability, vocab)
            return pg_resource.clone().add(attr.allocated).less_equal(capability)

        ssn.add_job_enqueueable_fn(self.name(), job_enqueueable_fn)

        def on_allocate(event) -> None:
            job = ssn.jobs[event.task.job]
            attr = self.queue_attrs[job.queue]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event) -> None:
            job = ssn.jobs[event.task.job]
            attr = self.queue_attrs[job.queue]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        def on_allocate_bulk(tasks, plan=None) -> None:
            # One dense sum per queue, one share recompute (state-equivalent to
            # folding on_allocate over the tasks).  With a CommitPlan the
            # per-queue sums arrive precomputed (plan.queue_all).
            if plan is not None:
                for queue_uid, row in plan.queue_all().items():
                    attr = self.queue_attrs[queue_uid]
                    attr.allocated.add_array(row)
                    self._update_share(attr)
                return
            from scheduler_tpu_torch.api.resource import sum_rows

            rows_by_queue: Dict[str, list] = {}
            for task in tasks:
                queue_uid = ssn.jobs[task.job].queue
                rows_by_queue.setdefault(queue_uid, []).append(task.resreq)
            for queue_uid, reqs in rows_by_queue.items():
                attr = self.queue_attrs[queue_uid]
                attr.allocated.add_array(*sum_rows(reqs))
                self._update_share(attr)

        def on_deallocate_bulk(tasks) -> None:
            # One dense sum per queue, one share recompute (state-equivalent
            # to folding on_deallocate over the tasks).
            from scheduler_tpu_torch.api.resource import sum_rows

            rows_by_queue: Dict[str, list] = {}
            for task in tasks:
                queue_uid = ssn.jobs[task.job].queue
                rows_by_queue.setdefault(queue_uid, []).append(task.resreq)
            for queue_uid, reqs in rows_by_queue.items():
                attr = self.queue_attrs[queue_uid]
                attr.allocated.sub_array(sum_rows(reqs)[0])
                self._update_share(attr)

        ssn.add_event_handler(
            EventHandler(
                allocate_func=on_allocate,
                deallocate_func=on_deallocate,
                bulk_allocate_func=on_allocate_bulk,
                bulk_deallocate_func=on_deallocate_bulk,
            )
        )

    def on_session_close(self, ssn) -> None:
        self.total_resource = None
        self.queue_attrs = {}
        self._qfair_evidence = {}


def new(arguments: Arguments) -> ProportionPlugin:
    return ProportionPlugin(arguments)
