"""Victim pre-gate for preempt/reclaim (``scheduler_tpu/ops/victims.py``).

The reference's victim hunt visits nodes one by one, enumerating each node's
Running tasks and running the victim dispatch per candidate
(``preempt.go:180-260``, ``reclaim.go:134-195``) — O(visits x candidates) of
host work, most of it on nodes that can never yield a victim.  This module
collapses the hopeless visits with ONE masked reduction over running-task
arrays, computed at action start:

  accept[t] = running[t]
              & gang_ok[job(t)]                       (gang survivability)
              & all_r(resreq[t] <= margin[queue(t)])  (proportion headroom)
  counts[node, queue] = segment_count(accept)

A hunt then admits a node only when its (node, queue-complement) count is
positive; the EXACT host dispatch still decides the victims on admitted
nodes, so placements and evictions are bit-identical to the ungated path.

Soundness (why start-of-action state gives an exact filter): every victim
dispatch is an intersection — plugins only SHRINK the candidate set — and
both builtin shrinkers are monotone over the action:

* gang: ``min_available <= occupied - 1`` with ``occupied`` only dropping
  (evictions; pipelining a preemptor is PIPELINED status, not ready-counted),
  so jobs rejected at start stay rejected.
* proportion: acceptance needs ``deserved <= allocated_after_eviction`` and
  queue ``allocated`` only drops as the action evicts, so the start margin
  ``allocated0 - deserved + eps`` only over-admits.

Plugins the gate does not model (conformance, third-party) are simply not
applied — a looser superset, never a miss.  Committed evictions decrement
the counts live (an evicted victim can never be offered again); everything
else only goes stale in the admitting direction.

Where it runs: the reductions are single numpy passes over the running
tasks, on the host, as in the JAX package (at victim-sweep sizes one pass
costs far less than a device round trip).  The proportion margins read
``ssn.device_queue_fair["proportion"]``: the deserved rows the session's
water-fill solved when it opened, on the card the ``qfair_solve`` kernel.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from scheduler_tpu_torch.api.types import TaskStatus

logger = logging.getLogger("scheduler_tpu_torch.victims")


def _first_victim_tier(ssn, registry: Dict, enabled_key: str) -> frozenset:
    """Plugins of the FIRST tier with any enabled victim fn — the only fns
    ``Session._victims`` is GUARANTEED to consult (a later tier runs only
    when every earlier tier's accumulated set stayed None, which is
    data-dependent).  The gate may model exactly these; modeling a
    later-tier plugin could reject a victim the short-circuited dispatch
    never shows to it."""
    for tier in ssn.tiers:
        names = frozenset(
            p.name
            for p in tier.plugins
            if getattr(p, enabled_key)() and p.name in registry
        )
        if names:
            return names
    return frozenset()


class VictimGate:
    """Per-action node admission for victim hunts.

    ``kind`` is "preempt" (preemptable dispatch) or "reclaim" (reclaimable
    dispatch) — gang registers in both, proportion only in reclaimable.
    Build is lazy: an action with no starved tasks never pays the scan.
    """

    def __init__(self, ssn, kind: str) -> None:
        self.ssn = ssn
        self.kind = kind
        self._built = False
        # Coverage evidence: node visits the gate admitted vs collapsed,
        # routed by the actions through ``note_evidence`` into the cycle's
        # ``victims`` note.
        self.counters: Dict[str, int] = {"admitted": 0, "skipped": 0}
        self._counts: Optional[np.ndarray] = None     # i64 [N, Q]
        self._min_req: Optional[np.ndarray] = None    # f64 [N, Q, R] elementwise min
        self._queues: list = []
        self._mins: Optional[np.ndarray] = None       # [R] epsilon thresholds
        self._prop_live = False
        self._row_of: Dict[str, int] = {}             # node name -> gate row
        self._queue_idx: Dict[str, int] = {}          # queue uid -> column
        self._own_cache: Dict[str, Optional[np.ndarray]] = {}  # job -> [N] counts
        # ordered-node-list id -> (gate-row array, pinning ref) — lets a hunt
        # select its admitted nodes with ONE vectorized gather instead of a
        # mask probe per node (sweep lists are memoized for the action, and
        # the pin keeps the id stable).
        self._ordered_rows: Dict[int, tuple] = {}
        # Gang verdict per job AS OF the build — _own_counts must subtract
        # with the SAME snapshot the [N, Q] counts were built with, or a
        # fresher verdict could over-subtract and miss real victims.
        self._gang_at_build: Dict[str, bool] = {}

    def prime(self) -> None:
        """Build NOW — actions call this before their first Statement op.  A
        lazy build inside an open Statement would capture temporarily-low
        gang occupancy that a later rollback restores, breaking the
        monotone-superset argument."""
        if not self._built:
            self._build()

    # -- construction ---------------------------------------------------------

    def _build(self) -> None:
        self._built = True
        ssn = self.ssn
        enabled_key = (
            "preemptable_enabled" if self.kind == "preempt" else "reclaimable_enabled"
        )
        registry = (
            ssn.preemptable_fns if self.kind == "preempt" else ssn.reclaimable_fns
        )
        first_tier = _first_victim_tier(ssn, registry, enabled_key)
        gang_live = "gang" in first_tier
        prop_live = self.kind == "reclaim" and "proportion" in first_tier

        # The queue axis covers REGISTERED queues plus any queue string a
        # running job still carries (a deleted queue's tasks remain valid
        # victims — preempt's filter compares queue strings, and gang-only
        # reclaim confs accept them; reclaim.py:52 logs-and-continues the
        # same state).  Proportion margins only exist for registered queues;
        # the rest get +inf (never filtered) — superset either way.
        queues = sorted(
            set(ssn.queues) | {job.queue for job in ssn.jobs.values()}
        )
        self._queues = queues
        self._queue_idx = {q: i for i, q in enumerate(queues)}
        nq = max(len(queues), 1)

        ledger = getattr(ssn.nodes, "ledger", None)
        if ledger is not None:
            self._row_of = dict(ledger.row_of)
            n_rows = ledger.n
        else:
            self._row_of = {name: i for i, name in enumerate(ssn.nodes)}
            n_rows = len(self._row_of)
        if n_rows == 0:
            self._counts = np.zeros((0, nq), dtype=np.int64)
            return

        vocab = ssn.cache.vocab if getattr(ssn, "cache", None) else None
        r = vocab.size if vocab is not None else 0

        # Proportion margins are evaluated LIVE per hunt (current_margins) —
        # at build we only record which queues/mins apply and keep the
        # per-(node, queue) elementwise victim-request MINIMUM, a lower
        # bound that start-of-action evictions can only raise (superset).
        if prop_live and ssn.device_queue_fair.get("proportion") is None:
            prop_live = False  # pragma: no cover - proportion without its seam
        self._prop_live = prop_live
        if prop_live:
            probe = ssn.device_queue_fair["proportion"](queues)
            r = probe["deserved"].shape[1]
            self._mins = (
                vocab.min_thresholds()[:r] if vocab is not None else np.zeros(r)
            )

        # Gather the running set columnar: per job, rows + node names.
        seg_node: list = []
        seg_queue: list = []
        req_rows: list = []
        jobs_gang_ok: list = []
        for job in ssn.jobs.values():
            rows = job.rows_with_status(TaskStatus.RUNNING)
            if rows.shape[0] == 0:
                continue
            qi = self._queue_idx.get(job.queue)
            if qi is None:
                continue
            if gang_live:
                occupied = job.ready_task_num()
                gang_ok = job.min_available <= occupied - 1 or job.min_available == 1
            else:
                gang_ok = True
            self._gang_at_build[job.uid] = gang_ok
            st = job.store
            names = st.node_name[rows]
            node_ids = np.asarray(
                [self._row_of.get(nm, -1) for nm in names.tolist()],
                dtype=np.int64,
            )
            seg_node.append(node_ids)
            seg_queue.append(np.full(rows.shape[0], qi, dtype=np.int64))
            jobs_gang_ok.append(np.full(rows.shape[0], gang_ok, dtype=bool))
            if prop_live:
                req, _, _ = job.request_matrices()
                w = min(req.shape[1], r)
                padded = np.zeros((rows.shape[0], r))
                padded[:, :w] = req[rows][:, :w]
                req_rows.append(padded)

        if not seg_node:
            self._counts = np.zeros((n_rows, nq), dtype=np.int64)
            return

        node_ids = np.concatenate(seg_node)
        queue_ids = np.concatenate(seg_queue)
        accept = np.concatenate(jobs_gang_ok)

        seg = np.where(accept & (node_ids >= 0), node_ids * nq + queue_ids, -1)
        live = seg >= 0
        counts = np.bincount(
            seg[live].astype(np.int64), minlength=n_rows * nq
        )
        self._counts = counts.reshape(n_rows, nq)

        if prop_live and r:
            reqs = np.concatenate(req_rows)
            # Elementwise per-(node, queue) MINIMUM over accepted victims —
            # the masked reduction the hunts compare against live margins.
            # A "phantom" victim combining different tasks' best dims only
            # loosens the gate (superset).  Sort + reduceat = one C pass.
            min_req = np.full((n_rows * nq, r), np.inf)
            if live.any():
                seg_l = seg[live]
                reqs_l = reqs[live]
                order = np.argsort(seg_l, kind="stable")
                sorted_seg = seg_l[order]
                starts = np.nonzero(np.diff(sorted_seg, prepend=-1))[0]
                min_req[sorted_seg[starts]] = np.minimum.reduceat(
                    reqs_l[order], starts, axis=0
                )
            self._min_req = min_req.reshape(n_rows, nq, r)

    # -- admission ------------------------------------------------------------

    def _current_margins(self) -> Optional[np.ndarray]:
        """LIVE proportion headroom per queue: allocated_now - deserved + eps.
        Queue allocated only drops during the action, so re-reading it per
        hunt keeps the gate tight without ever under-admitting."""
        if not self._prop_live:
            return None
        fair = self.ssn.device_queue_fair["proportion"](self._queues)
        margins = fair["allocated"] - fair["deserved"] + self._mins[None, :]
        # Unregistered queues (running victims of a deleted queue) have no
        # proportion attrs — the fair rows are zeros; never filter on them.
        for i, q in enumerate(self._queues):
            if q not in self.ssn.queues:
                margins[i] = np.inf
        return margins

    def other_queue_mask(self, queue_uid: str) -> Optional[np.ndarray]:
        """[N] bool by gate row: nodes that can still yield a victim for a
        reclaimer of this queue, under live margins.  One vectorized pass per
        HUNT instead of a dispatch per node."""
        if not self._built:
            self._build()
        counts = self._counts
        if counts is None or counts.size == 0:
            return None
        ok = counts > 0  # [N, Q]
        margins = self._current_margins()
        if margins is not None and self._min_req is not None:
            # _min_req's R axis is frozen at gate build; margins re-probe the
            # LIVE vocab each hunt, so a scalar registered mid-action makes
            # the widths diverge.  Compare on the common prefix (vocab is
            # append-only, so column k means the same resource in both).
            r = min(self._min_req.shape[2], margins.shape[1])
            ok = ok & np.all(
                self._min_req[:, :, :r] <= margins[None, :, :r], axis=2
            )
        qi = self._queue_idx.get(queue_uid, -1)
        if qi >= 0:
            ok = ok.copy()
            ok[:, qi] = False
        return ok.any(axis=1)

    def note_eviction(self, node_name: str, job) -> None:
        """LIVE presence decrement after a COMMITTED eviction — the evicted
        victim can never be offered again, so dropping it keeps the counts a
        tight superset (stale-high counts were the residual cost: every
        later hunt re-visited every already-drained node).  Only decrements
        victims the build actually counted (its job was gang-ok then);
        anything else was never in the counts."""
        if not self._built or self._counts is None:
            return
        if not self._gang_at_build.get(job.uid, False):
            return
        row = self._row_of.get(node_name)
        qi = self._queue_idx.get(job.queue, -1)
        if row is None or qi < 0 or row >= self._counts.shape[0]:
            return
        if self._counts[row, qi] > 0:
            self._counts[row, qi] -= 1
        own = self._own_cache.get(job.uid)
        if own is not None and row < own.shape[0] and own[row] > 0:
            own[row] -= 1

    def note_evicted_task(self, task) -> None:
        """Statement.commit's ``on_evicted`` hook: fold ONE cache-accepted
        eviction into the live counts.  Wired per-success (not per recorded
        op) because a failed evict RPC restores the victim — it can still be
        offered, so its count must survive."""
        job = self.ssn.jobs.get(task.job)
        if job is not None and task.node_name:
            self.note_eviction(task.node_name, job)

    def _count(self, admitted: bool) -> bool:
        """Book one node-visit verdict into the evidence counters and pass
        it through — every admission path funnels here so the evidence's
        gated-vs-ungated coverage cannot drift from the real decisions."""
        self.counters["admitted" if admitted else "skipped"] += 1
        return admitted

    def stats(self) -> dict:
        """The ``victims`` evidence block for one action:
        whether the gate ran, and its admit/skip verdict counts."""
        return {
            "enabled": True,
            "kind": self.kind,
            "built": self._built,
            "admitted": self.counters["admitted"],
            "skipped": self.counters["skipped"],
        }

    @staticmethod
    def note_evidence(kind: str, gate: Optional["VictimGate"]) -> None:
        """Merge one action's gate evidence into the cycle's ``victims``
        note (preempt and reclaim both run per cycle; the note carries
        both, keyed by kind — the evict note's pattern)."""
        from scheduler_tpu_torch.utils import phases

        if not phases.active():
            return
        cur = dict(phases.get_note("victims") or {})
        cur[kind] = (
            gate.stats() if gate is not None else {"enabled": False, "kind": kind}
        )
        phases.note("victims", cur)

    def admitted_positions(self, ordered_nodes, mask: np.ndarray) -> np.ndarray:
        """Positions in ``ordered_nodes`` whose gate row passes ``mask`` —
        one vectorized gather per hunt instead of a Python probe per node
        (a 1000-node scan costs ~1000 dict+bool hits otherwise)."""
        key = id(ordered_nodes)
        hit = self._ordered_rows.get(key)
        if hit is None or hit[1] is not ordered_nodes:
            rows = np.asarray(
                [self._row_of.get(n.name, -1) for n in ordered_nodes],
                dtype=np.int64,
            )
            self._ordered_rows[key] = hit = (rows, ordered_nodes)
        rows = hit[0]
        if rows.shape[0] == 0:
            return rows
        safe = np.clip(rows, 0, max(mask.shape[0] - 1, 0))
        ok = np.where(
            (rows >= 0) & (rows < mask.shape[0]), mask[safe], True
        )  # unknown rows: never gate out
        out = np.nonzero(ok)[0]
        self.counters["admitted"] += int(out.shape[0])
        self.counters["skipped"] += int(rows.shape[0] - out.shape[0])
        return out

    def admits_other_job(self, node_name: str, job) -> bool:
        """Preempt phase 1: the SAME queue's other jobs have an acceptable
        victim on this node."""
        if not self._built:
            self._build()
        row = self._row_of.get(node_name)
        if row is None or self._counts is None or row >= self._counts.shape[0]:
            return self._count(True)
        qi = self._queue_idx.get(job.queue, -1)
        if qi < 0:
            return self._count(False)
        own = self._own_counts(job)
        own_here = int(own[row]) if own is not None else 0
        return self._count(int(self._counts[row, qi]) - own_here > 0)

    def admits_own_job(self, node_name: str, job) -> bool:
        """Preempt phase 2: the job's own acceptable victims ran here."""
        if not self._built:
            self._build()
        row = self._row_of.get(node_name)
        if row is None:
            return self._count(True)
        own = self._own_counts(job)
        if own is None:
            return self._count(True)
        return self._count(row < own.shape[0] and int(own[row]) > 0)

    def _own_counts(self, job) -> Optional[np.ndarray]:
        hit = self._own_cache.get(job.uid, False)
        if hit is not False:
            return hit
        rows = job.rows_with_status(TaskStatus.RUNNING)
        n_rows = self._counts.shape[0] if self._counts is not None else 0
        # The BUILD-TIME gang verdict, not a fresh one: the [N, Q] counts
        # include this job's rows iff it was gang-ok then, and the
        # subtraction must mirror that exactly (a job absent from the build
        # had no running rows — contributes zero either way).
        gang_ok = self._gang_at_build.get(job.uid, False)
        if rows.shape[0] == 0 or n_rows == 0 or not gang_ok:
            out = np.zeros(max(n_rows, 1), dtype=np.int64)
        else:
            names = job.store.node_name[rows]
            ids = np.asarray(
                [self._row_of.get(nm, -1) for nm in names.tolist()], dtype=np.int64
            )
            out = np.bincount(ids[ids >= 0], minlength=n_rows)
        self._own_cache[job.uid] = out
        return out


