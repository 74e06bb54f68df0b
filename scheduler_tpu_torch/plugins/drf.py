"""DRF plugin: Dominant Resource Fairness across jobs
(reference ``plugins/drf/drf.go``).

A job's share = max over resource dims of allocated/clusterTotal; jobs order by
lower share, and a preemptor may take from a preemptee whose post-eviction share
stays >= the preemptor's post-allocation share (within shareDelta).  Shares stay
live through session allocate/deallocate event handlers.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.resource import ResourceVec, share as share_fn
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import EventHandler, Plugin

logger = logging.getLogger("scheduler_tpu_torch.plugins.drf")

SHARE_DELTA = 0.000001


class _DrfAttr:
    __slots__ = ("share", "allocated")

    def __init__(self, allocated: ResourceVec) -> None:
        self.allocated = allocated
        self.share = 0.0


class DrfPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.total_resource: ResourceVec = None  # type: ignore[assignment]
        self.job_attrs: Dict[str, _DrfAttr] = {}
        self._share_mask = None  # memoized participating-dims mask

    def name(self) -> str:
        return "drf"

    def _calculate_share(self, allocated: ResourceVec) -> float:
        """Dominant share, vectorized over the total's participating dims
        (cpu, memory, nonzero scalars): bit-equivalent to folding share_fn
        over ``resource_names()`` — same division, same 0-total convention —
        without per-name string lookups (~8us x jobs per commit)."""
        tot = self.total_resource.array
        mask = self._share_mask
        if mask is None or mask.shape[0] != tot.shape[0]:
            mask = np.zeros(tot.shape[0], dtype=bool)
            mask[:2] = True
            mask[2:] = tot[2:] != 0.0
            self._share_mask = mask
        a = np.zeros(tot.shape[0])
        arr = allocated.array
        n = min(arr.shape[0], tot.shape[0])
        a[:n] = arr[:n]
        with np.errstate(divide="ignore", invalid="ignore"):
            fr = np.where(tot > 0.0, a / np.where(tot > 0.0, tot, 1.0),
                          (a != 0.0).astype(np.float64))
        fr = fr[mask]
        return float(fr.max()) if fr.shape[0] else 0.0

    def _update_share(self, attr: _DrfAttr) -> None:
        attr.share = self._calculate_share(attr.allocated)

    def on_session_open(self, ssn) -> None:
        vocab = next(iter(ssn.jobs.values())).vocab if ssn.jobs else None
        if vocab is None:
            return
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

        for job in ssn.jobs.values():
            # The maintained job aggregate IS the sum over allocated-status
            # tasks (fold of add_task_info/update_task_status) — and it is the
            # SAME value the fused engine seeds its on-device DRF carry with
            # (ops/fused.py alloc_init), so host and device shares agree by
            # construction.  O(R) per job: all-running 100k-task jobs pay
            # nothing per cycle.
            attr = _DrfAttr(job.allocated.clone())
            self._update_share(attr)
            self.job_attrs[job.uid] = attr

        def preemptable_fn(preemptor: TaskInfo, preemptees):
            victims = None
            latt = self.job_attrs[preemptor.job]
            lalloc = latt.allocated.clone().add(preemptor.resreq)
            ls = self._calculate_share(lalloc)

            allocations: Dict[str, ResourceVec] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    ratt = self.job_attrs[preemptee.job]
                    allocations[preemptee.job] = ratt.allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                rs = self._calculate_share(ralloc)
                if ls < rs or math.isclose(ls, rs, abs_tol=SHARE_DELTA):
                    victims = victims or []
                    victims.append(preemptee)
            logger.debug("DRF victims: %s", victims)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)

        def on_allocate(event) -> None:
            attr = self.job_attrs[event.task.job]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event) -> None:
            attr = self.job_attrs[event.task.job]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        def on_allocate_bulk(tasks, plan=None) -> None:
            # Vectorized form of folding on_allocate over the tasks: one dense
            # sum per job, one share recompute.  With a CommitPlan the per-job
            # sums arrive precomputed (plan.job_all — DRF counts pipelined
            # placements too, drf.go:135-154).
            if plan is not None:
                for job_uid, row in plan.job_all().items():
                    attr = self.job_attrs[job_uid]
                    attr.allocated.add_array(row)
                    self._update_share(attr)
                return
            from scheduler_tpu_torch.api.resource import sum_rows

            rows_by_job: Dict[str, list] = {}
            for task in tasks:
                rows_by_job.setdefault(task.job, []).append(task.resreq)
            for job_uid, reqs in rows_by_job.items():
                attr = self.job_attrs[job_uid]
                attr.allocated.add_array(*sum_rows(reqs))
                self._update_share(attr)

        def on_deallocate_bulk(tasks) -> None:
            # Vectorized fold of on_deallocate: one dense sum per job, one
            # share recompute (evictions arrive in per-commit batches).
            from scheduler_tpu_torch.api.resource import sum_rows

            rows_by_job: Dict[str, list] = {}
            for task in tasks:
                rows_by_job.setdefault(task.job, []).append(task.resreq)
            for job_uid, reqs in rows_by_job.items():
                attr = self.job_attrs[job_uid]
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
        self.total_resource = None  # type: ignore[assignment]
        self.job_attrs = {}
        self._share_mask = None  # totals change between sessions


def new(arguments: Arguments) -> DrfPlugin:
    return DrfPlugin(arguments)
