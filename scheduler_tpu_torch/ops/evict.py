"""The victim hunt for preempt/reclaim: its shared rules and the batched
eviction engine (``scheduler_tpu/ops/evict.py:84-978``).

The reference's victim hunt is a per-node Python pipeline — enumerate the
node's Running tasks, clone them, run the tiered victim dispatch per
candidate, heap-sort the survivors, evict a sufficiency prefix
(``preempt.go:180-260``, ``reclaim.go:134-195``).  The actions
(``actions/preempt.py``, ``actions/reclaim.py``) run that walk, pre-gated
by ``ops/victims.py``, in the default ``host`` flavor.  This module holds:

* ``evict_flavor``: ``SCHEDULER_TORCH_EVICT`` = ``host`` (default) |
  ``device``;
* ``enabled_victim_fns``: the victim plugins registered and tier-enabled,
  in dispatch order;
* ``FloorGuard``: the live gang floor — one hunt's sufficiency prefix never
  strands a cohort below ``min_member``;
* ``EvictEngine``, the ``device`` flavor: the whole hunt as batched
  reductions over the running-task ledgers, which the actions replay
  through the session (evictions and binds identical to the host walk).
  Its parts: a victim order ``[V]`` (every running task's rank under the
  builtin task order, built once an action); the victim dispatch masks
  reproducing the tiered ``_victims`` intersection per node segment
  (conformance's critical-pod veto, gang's ``min_available <= occupied -
  1``, DRF's dominant-share test along the cumulative per-job chain in
  candidate order, proportion's ``deserved <= allocated-after-eviction``);
  the live gang floor as a counter decremented as victims enter the plan;
  the sufficiency prefix over the kept victims' request cumsum; and the
  pick of the earliest sweep-order node holding a sufficient plan;
* the ``evict`` evidence note (``note_evidence``).

As in the JAX package, the mask, plan and pick math is float64 numpy on
the host: at victim-sweep sizes one vectorized pass is far below a device
round trip, and what makes the hunt fast is one reduction a hunt instead
of a Python dispatch a node and candidate.  The JAX mesh pick
(``sharded_victim_pick``) waits for the port's mesh.

Exactness gate: the engine engages only when it can model the session
exactly — enabled victim fns within {conformance, gang, drf} (preempt) /
{conformance, gang, proportion} (reclaim), builtin task order, no scalar
resources in play.  Anything else records the reason in the evidence block
and runs the unchanged host hunt.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.utils import metrics

logger = logging.getLogger("scheduler_tpu_torch.evict")

# Victim fns the engine models exactly, per action kind.  DRF registers only
# preemptable, proportion only reclaimable, gang + conformance both.
_MODELED = {
    "preempt": frozenset(("conformance", "gang", "drf")),
    "reclaim": frozenset(("conformance", "gang", "proportion")),
}

CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")
KUBE_SYSTEM_NAMESPACE = "kube-system"

# DRF's math.isclose tolerance pair (plugins/drf.py SHARE_DELTA + the stdlib
# default rel_tol) — replicated exactly by the vectorized accept mask.
_SHARE_DELTA = 0.000001
_REL_TOL = 1e-9


def evict_flavor() -> str:
    """The victim-hunt flavor: ``host`` (default, the reference per-node
    walk) or ``device`` (the batched plan engine), from
    ``SCHEDULER_TORCH_EVICT``.  The allocate engine never reads it, so it
    is not part of the engine cache's key."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_EVICT", "host", choices=("host", "device"))


def enabled_victim_fns(ssn, kind: str) -> tuple:
    """(plugin name, plugin object) pairs whose victim fn is registered AND
    tier-enabled, in dispatch order, one tuple a tier — THE single source
    for the engine's modeling gate and the host path's FloorGuard
    applicability."""
    enabled_key = (
        "preemptable_enabled" if kind == "preempt" else "reclaimable_enabled"
    )
    registry = ssn.preemptable_fns if kind == "preempt" else ssn.reclaimable_fns
    out = []
    for tier in ssn.tiers:
        tier_list = []
        for plugin in tier.plugins:
            if getattr(plugin, enabled_key)() and plugin.name in registry:
                tier_list.append((plugin.name, plugin))
        out.append(tuple(tier_list))
    return tuple(out)


class FloorGuard:
    """The live gang floor, host-hunt side: re-applies the gang plugin's own
    formula per ACCEPTED victim with a locally-decremented ready count, so a
    single hunt's sufficiency prefix can never strand a cohort below
    ``min_member``.  The device plan's kept-mask applies the identical
    ``k <= occupied - min_available`` rule, which keeps the two flavors
    equal.

    Counts are LOCAL (captured at first sight, decremented per take) — the
    preempt loop's interleaved ``stmt.evict`` calls already decrement the
    session's ready counts, and reading them live would double-count.
    ``None`` when gang is not an enabled victim fn for the kind: sessions
    without gang must not grow a floor the dispatch never imposed."""

    def __init__(self, ssn) -> None:
        self.ssn = ssn
        self._room: Dict[str, Optional[int]] = {}

    @classmethod
    def for_session(cls, ssn, kind: str) -> Optional["FloorGuard"]:
        for tier_list in enabled_victim_fns(ssn, kind):
            for name, _ in tier_list:
                if name == "gang":
                    return cls(ssn)
        return None

    def take(self, victim) -> bool:
        """True when evicting ``victim`` keeps its job at/above the floor
        (and books the eviction); False skips the victim."""
        job = self.ssn.jobs.get(victim.job)
        if job is None:
            return True
        room = self._room.get(victim.job)
        if room is None:
            if job.min_available == 1:
                self._room[victim.job] = room = -1  # unlimited, gang's carve-out
            else:
                self._room[victim.job] = room = (
                    job.ready_task_num() - job.min_available
                )
        if room < 0:
            return True
        if room == 0:
            return False
        self._room[victim.job] = room - 1
        return True


# -- the engine ---------------------------------------------------------------


class EvictEngine:
    """Per-action batched victim-plan engine.  Built fresh by every
    preempt/reclaim execution (one session, one cycle — never resident in
    the engine cache).  ``active`` is the exactness gate; when False the
    action runs the unchanged host hunt and ``stats()`` records why."""

    def __init__(self, ssn, kind: str) -> None:
        assert kind in ("preempt", "reclaim")
        self.ssn = ssn
        self.kind = kind
        self.flavor = evict_flavor()
        self._reason: Optional[str] = None
        self._plugins: tuple = ()
        self._built = False
        # Victim table (build_tables): one row per RUNNING task at prime.
        self._uids: List[str] = []
        self._jobs: List[str] = []          # victim -> job uid
        self._job_rows: Optional[np.ndarray] = None   # store row per victim
        self._vjob: Optional[np.ndarray] = None       # victim -> job index
        self._vnode: Optional[np.ndarray] = None      # victim -> gate node row
        self._vqueue: Optional[np.ndarray] = None     # victim -> queue index
        self._pos: Optional[np.ndarray] = None        # candidate-order key
        self._rank: Optional[np.ndarray] = None       # builtin task-order rank
        self._req: Optional[np.ndarray] = None        # [V, R] f64
        self._critical: Optional[np.ndarray] = None   # conformance veto
        self._job_list: List[str] = []
        self._job_idx: Dict[str, int] = {}
        self._min_avail: Optional[np.ndarray] = None  # [J]
        self._job_objs: List = []
        self._by_job_rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._queues: List[str] = []
        self._queue_idx: Dict[str, int] = {}
        self._row_of: Dict[str, int] = {}
        self._mins: Optional[np.ndarray] = None
        self._pos_counter = 0
        self._ordered_rows: Dict[int, tuple] = {}
        # Evidence counters (run_stats -> phases.note("evict") -> bench
        # detail.cycles[].evict).
        self.counters = {
            "hunts": 0, "planned_nodes": 0, "evictions": 0, "pipelined": 0,
            "segments": 0, "device_picks": 0,
        }
        self.phase = {"score": 0.0, "mask": 0.0, "plan": 0.0, "replay": 0.0}
        self._check_active()

    # -- gate -----------------------------------------------------------------

    def _check_active(self) -> None:
        if self.flavor != "device":
            self._reason = "flavor host"
            return
        tiers = enabled_victim_fns(self.ssn, self.kind)
        names = [name for tier in tiers for name, _ in tier]
        extra = sorted(set(names) - _MODELED[self.kind])
        if extra:
            self._reason = f"unmodeled victim plugins: {', '.join(extra)}"
            return
        self._plugins = tiers
        if self.kind == "preempt":
            from scheduler_tpu_torch.utils.scheduler_helper import task_order_builtin

            if not task_order_builtin(self.ssn):
                self._reason = "non-builtin task order"
                return
        if self.kind == "reclaim" and any(
            name == "proportion" for tier in tiers for name, _ in tier
        ):
            prop = self._plugin("proportion")
            if prop is None or not getattr(prop, "queue_attrs", None):
                self._reason = "proportion victim fn without queue attrs"
                return

    @property
    def active(self) -> bool:
        return self._reason is None

    def _plugin(self, name: str):
        """The LIVE plugin instance (``ssn.plugins``) when ``name`` is an
        enabled victim fn — the tier registry holds conf ``PluginOption``
        rows, but the masks need the instance's session state (drf
        ``job_attrs``, proportion ``queue_attrs``)."""
        for tier in self._plugins:
            for n, _ in tier:
                if n == name:
                    return self.ssn.plugins.get(name)
        return None

    # -- build ----------------------------------------------------------------

    def prime(self) -> None:
        """Build the victim table NOW — before the action's first Statement
        op, for the same reason ``VictimGate.prime`` exists: capture must see
        the action's start state."""
        if not self.active or self._built:
            return
        t0 = time.perf_counter()
        self._built = True
        ssn = self.ssn
        ledger = getattr(ssn.nodes, "ledger", None)
        if ledger is not None:
            self._row_of = dict(ledger.row_of)
        else:
            self._row_of = {name: i for i, name in enumerate(ssn.nodes)}

        self._queues = sorted(
            set(ssn.queues) | {job.queue for job in ssn.jobs.values()}
        )
        self._queue_idx = {q: i for i, q in enumerate(self._queues)}

        vocab = ssn.cache.vocab if getattr(ssn, "cache", None) else None
        r = vocab.size if vocab is not None else 0

        uids: List[str] = []
        vjobs: List[str] = []
        job_rows: List[int] = []
        vjob: List[int] = []
        vnode: List[int] = []
        vqueue: List[int] = []
        reqs: List[np.ndarray] = []
        critical: List[bool] = []
        order_keys: List[tuple] = []
        has_scalars = False

        for node in ssn.nodes.values():
            row = self._row_of.get(node.name, -1)
            for task in node.tasks.values():
                if task.status != TaskStatus.RUNNING:
                    continue
                job = ssn.jobs.get(task.job)
                if job is None:
                    continue
                juid = task.job
                ji = self._job_idx.get(juid)
                if ji is None:
                    ji = len(self._job_list)
                    self._job_idx[juid] = ji
                    self._job_list.append(juid)
                    self._job_objs.append(job)
                uids.append(task.uid)
                vjobs.append(juid)
                job_rows.append(job.store.row_of.get(task.uid, -1))
                vjob.append(ji)
                vnode.append(row)
                vqueue.append(self._queue_idx.get(job.queue, -1))
                arr = task.resreq.array
                w = min(arr.shape[0], r) if r else arr.shape[0]
                padded = np.zeros(max(r, arr.shape[0]))
                padded[:w] = arr[:w]
                reqs.append(padded)
                has_scalars = has_scalars or task.resreq.has_scalars
                pod = task.pod
                critical.append(
                    pod is not None
                    and (pod.priority_class_name in CRITICAL_PRIORITY_CLASSES
                         or pod.namespace == KUBE_SYSTEM_NAMESPACE)
                )
                # Builtin task order key; victims evict in DESCENDING rank
                # (preempt.go:219-224 inverts TaskOrderFn; our heap's uid
                # tie-break makes the order total, so one global sort is it).
                order_keys.append(
                    (-task.priority, task.req_sig, task.creation_timestamp,
                     task.uid)
                )

        v = len(uids)
        self._uids = uids
        # uid -> victim index, frozen with the capture: note_discard /
        # note_commit run once per statement and must not pay an O(V)
        # rebuild each time on the measured path.
        self._uid_to_v = {u: i for i, u in enumerate(uids)}
        self._jobs = vjobs
        self._job_rows = np.asarray(job_rows, dtype=np.int64)
        self._vjob = np.asarray(vjob, dtype=np.int64)
        self._vnode = np.asarray(vnode, dtype=np.int64)
        self._vqueue = np.asarray(vqueue, dtype=np.int64)
        self._pos = np.arange(v, dtype=np.int64)
        self._pos_counter = v
        self._req = (
            np.stack(reqs) if reqs else np.zeros((0, max(r, 1)))
        )
        self._critical = np.asarray(critical, dtype=bool)
        self._min_avail = np.asarray(
            [j.min_available for j in self._job_objs], dtype=np.int64
        )
        order = sorted(range(v), key=lambda i: order_keys[i])
        rank = np.empty(v, dtype=np.int64)
        rank[np.asarray(order, dtype=np.int64)] = np.arange(v)
        self._rank = rank
        self._mins = (
            vocab.min_thresholds()[: self._req.shape[1]]
            if vocab is not None
            else np.zeros(self._req.shape[1])
        )
        if self._mins.shape[0] < self._req.shape[1]:
            self._mins = np.pad(
                self._mins, (0, self._req.shape[1] - self._mins.shape[0])
            )
        # Per-job (victim indices, store rows) for the live status gather.
        for ji in range(len(self._job_list)):
            idx = np.nonzero(self._vjob == ji)[0]
            self._by_job_rows[ji] = (idx, self._job_rows[idx])
        if has_scalars:
            self._reason = "scalar resources in play"
        if self.kind == "preempt":
            drf = self._plugin("drf")
            if drf is not None and getattr(drf, "total_resource", None) is None:
                self._reason = "drf victim fn without session totals"
        self.phase["score"] += time.perf_counter() - t0

    # -- live gathers ----------------------------------------------------------

    def _alive(self) -> np.ndarray:
        """Victims still RUNNING, read fresh from the job stores (one
        vectorized gather per job — the engine keeps no mirror that could
        drift from the session's truth)."""
        out = np.zeros(len(self._uids), dtype=bool)
        for ji, (idx, rows) in self._by_job_rows.items():
            st = self._job_objs[ji].store
            ok = rows >= 0
            safe = np.where(ok, rows, 0)
            out[idx] = ok & (st.status[safe] == int(TaskStatus.RUNNING))
        return out

    def _occupied(self, jset: np.ndarray) -> np.ndarray:
        """Live ready counts for the job indices in ``jset`` (full [J] array,
        only ``jset`` rows meaningful)."""
        occ = np.zeros(len(self._job_list), dtype=np.int64)
        for ji in np.unique(jset):
            occ[ji] = self._job_objs[int(ji)].ready_task_num()
        return occ

    def _ordered_node_rows(self, ordered) -> Tuple[np.ndarray, Dict[int, int]]:
        """(gate rows of the ordered sweep list, row -> sweep position map),
        memoized per list identity (sweep lists are memoized per action)."""
        key = id(ordered)
        hit = self._ordered_rows.get(key)
        if hit is None or hit[2] is not ordered:
            rows = np.asarray(
                [self._row_of.get(n.name, -1) for n in ordered],
                dtype=np.int64,
            )
            row_pos = {int(r): i for i, r in enumerate(rows)}
            self._ordered_rows[key] = hit = (rows, row_pos, ordered)
        return hit[0], hit[1]

    # -- dispatch simulation ---------------------------------------------------

    def _victims_masks(
        self, cand: np.ndarray, starts: np.ndarray, seg_id: np.ndarray,
        preemptor,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The tiered ``Session._victims`` dispatch, vectorized per node
        segment over the hunt's candidate rows (``cand`` = victim indices
        sorted by (node, pos)).  Returns (member mask [C], has_victims per
        segment [S]) reproducing the init/intersect/collapse-to-None
        semantics of ``framework/session.py:254-283`` exactly."""
        n_seg = starts.shape[0]
        member = np.zeros(cand.shape[0], dtype=bool)
        cur_none = np.zeros(n_seg, dtype=bool)
        initialized = np.zeros(n_seg, dtype=bool)
        decided = np.zeros(n_seg, dtype=bool)

        occ = None
        for tier in self._plugins:
            for name, plugin in tier:
                if name == "conformance":
                    m = ~self._critical[cand]
                elif name == "gang":
                    if occ is None:
                        occ = self._occupied(self._vjob[cand])
                    ma = self._min_avail[self._vjob[cand]]
                    m = (ma <= occ[self._vjob[cand]] - 1) | (ma == 1)
                elif name == "drf":
                    m = self._drf_mask(
                        cand, starts, seg_id, preemptor, self._plugin(name)
                    )
                elif name == "proportion":
                    m = self._proportion_mask(
                        cand, starts, seg_id, self._plugin(name)
                    )
                else:  # pragma: no cover - gated out by _check_active
                    raise AssertionError(f"unmodeled victim plugin {name}")
                any_p = (
                    np.logical_or.reduceat(m, starts)
                    if cand.shape[0] else np.zeros(0, dtype=bool)
                )
                upd = ~decided
                fresh = upd & ~initialized
                inter_seg = upd & initialized
                # Intersection for already-initialized segments: a None
                # current set stays None (the host's ``victims or []``).
                new_member = member & m & ~cur_none[seg_id]
                any_new = (
                    np.logical_or.reduceat(new_member, starts)
                    if cand.shape[0] else np.zeros(0, dtype=bool)
                )
                member = np.where(
                    fresh[seg_id], m,
                    np.where(inter_seg[seg_id], new_member, member),
                )
                cur_none = np.where(
                    fresh, ~any_p, np.where(inter_seg, ~any_new, cur_none)
                )
                initialized = initialized | fresh
            decided = decided | (initialized & ~cur_none)
        has_victims = decided & ~cur_none
        return member & has_victims[seg_id], has_victims

    @staticmethod
    def _group_cumsum(reqs: np.ndarray, sorted_group: np.ndarray) -> np.ndarray:
        """Per-group INCLUSIVE cumulative sum over pre-sorted rows — one
        ``np.add.accumulate`` reproducing the host walk's exact
        ``((a0 - r1) - r2)...`` float order (the proportion fast-path
        precedent, plugins/proportion.py:199-203).  Rows must be sorted so
        equal ``sorted_group`` ids are contiguous in walk order."""
        c = np.add.accumulate(reqs, axis=0)
        starts = np.nonzero(np.diff(sorted_group, prepend=-1))[0]
        counts = np.diff(np.append(starts, sorted_group.shape[0]))
        base = np.repeat(c[starts] - reqs[starts], counts, axis=0)
        return c - base

    def _share_rows(self, alloc: np.ndarray, drf) -> np.ndarray:
        """Vectorized twin of ``DrfPlugin._calculate_share`` over [K, R]
        allocation rows — same participating-dims mask, same division, same
        0-total convention, rowwise max."""
        tot = drf.total_resource.array
        mask = np.zeros(tot.shape[0], dtype=bool)
        mask[:2] = True
        mask[2:] = tot[2:] != 0.0
        a = np.zeros((alloc.shape[0], tot.shape[0]))
        n = min(alloc.shape[1], tot.shape[0])
        a[:, :n] = alloc[:, :n]
        with np.errstate(divide="ignore", invalid="ignore"):
            fr = np.where(
                tot[None, :] > 0.0,
                a / np.where(tot[None, :] > 0.0, tot[None, :], 1.0),
                (a != 0.0).astype(np.float64),
            )
        fr = fr[:, mask]
        return (
            fr.max(axis=1) if fr.shape[1] else np.zeros(alloc.shape[0])
        )

    def _drf_mask(self, cand, starts, seg_id, preemptor, drf) -> np.ndarray:
        """DRF preemptable (plugins/drf.py:100-117), vectorized: victims
        whose post-eviction dominant share stays >= the preemptor's post-
        allocation share (within shareDelta), with the per-job allocation
        chain cumulative in candidate order per dispatch (= per node)."""
        latt = drf.job_attrs[preemptor.job]
        lalloc = latt.allocated.clone().add(preemptor.resreq)
        ls = drf._calculate_share(lalloc)

        jalloc = np.stack(
            [drf.job_attrs[u].allocated.array for u in self._job_list]
        ) if self._job_list else np.zeros((0, self._req.shape[1]))
        # Chain groups: (node segment, job) contiguous in pos order — cand
        # is (node, pos)-sorted, so a stable per-(seg, job) regroup keeps
        # the walk order inside each group.
        group = seg_id * max(len(self._job_list), 1) + self._vjob[cand]
        order = np.argsort(group, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(order.shape[0])
        reqs = self._req[cand][order]
        base = np.zeros((max(jalloc.shape[0], 1), reqs.shape[1]))
        if jalloc.size:
            w = min(jalloc.shape[1], reqs.shape[1])
            base[: jalloc.shape[0], :w] = jalloc[:, :w]
        gsum = self._group_cumsum(reqs, group[order])
        chain = base[self._vjob[cand][order]] - gsum
        pre = chain + reqs
        # The host chain's ``.sub`` asserts sufficiency per step
        # (resource_info.go Sub); replicate the check with the shared
        # epsilon rule so a violating session fails the same way.
        from scheduler_tpu_torch.api.resource import le_mask
        from scheduler_tpu_torch.utils.assertions import assert_that

        assert_that(
            bool(np.all(le_mask(reqs, pre, self._mins))),
            "resource is not sufficient for drf victim walk",
        )
        rs = self._share_rows(chain, drf)
        close = np.abs(ls - rs) <= np.maximum(
            _REL_TOL * np.maximum(np.abs(ls), np.abs(rs)), _SHARE_DELTA
        )
        return ((ls < rs) | close)[inv]

    def _proportion_mask(self, cand, starts, seg_id, prop) -> np.ndarray:
        """Proportion reclaimable (plugins/proportion.py reclaimable_fn
        columnar fast path), vectorized across node segments: per (node,
        queue) cumulative allocation chain, accept while
        ``deserved <= remaining`` under the shared epsilon rule."""
        from scheduler_tpu_torch.api.resource import le_mask
        from scheduler_tpu_torch.utils.assertions import assert_that

        q_uids = self._queues
        alloc_rows = np.zeros((len(q_uids), self._req.shape[1]))
        deserved_rows = np.zeros((len(q_uids), self._req.shape[1]))
        known = np.zeros(len(q_uids), dtype=bool)
        for i, q in enumerate(q_uids):
            attr = prop.queue_attrs.get(q)
            if attr is None:
                continue
            known[i] = True
            a, d = attr.allocated.array, attr.deserved.array
            w = min(a.shape[0], alloc_rows.shape[1])
            alloc_rows[i, :w] = a[:w]
            w = min(d.shape[0], deserved_rows.shape[1])
            deserved_rows[i, :w] = d[:w]
        vq = self._vqueue[cand]
        group = seg_id * max(len(q_uids), 1) + vq
        order = np.argsort(group, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(order.shape[0])
        reqs = self._req[cand][order]
        gsum = self._group_cumsum(reqs, group[order])
        chain = alloc_rows[vq[order]] - gsum
        pre = chain + reqs
        assert_that(
            bool(np.all(le_mask(reqs, pre, self._mins))),
            "resource is not sufficient for reclaim walk",
        )
        ok = le_mask(deserved_rows[vq[order]], chain, self._mins)
        # Victims of a queue without proportion attrs never reach the host
        # fast path (the dispatch KeyErrors); the gate keeps such sessions
        # on the host walk, so ``known`` is always all-True here — kept as
        # a belt against drift.
        ok = ok & known[vq[order]]
        return ok[inv]

    # -- plan -----------------------------------------------------------------

    def _segment_candidates(self, mask: np.ndarray):
        """(cand indices sorted by (node, pos), segment starts, seg_id,
        segment node rows) for the victims selected by ``mask``."""
        cand = np.nonzero(mask)[0]
        if cand.shape[0] == 0:
            return cand, np.zeros(0, np.int64), np.zeros(0, np.int64), {}
        order = np.lexsort((self._pos[cand], self._vnode[cand]))
        cand = cand[order]
        nodes = self._vnode[cand]
        starts = np.nonzero(np.diff(nodes, prepend=-1))[0]
        seg_id = np.cumsum(np.diff(nodes, prepend=-1) != 0) - 1
        seg_node = {int(s): int(nodes[st]) for s, st in enumerate(starts)}
        return cand, starts, seg_id, seg_node

    def _plan_segments(
        self, preemptor, cand_mask: np.ndarray, resreq: np.ndarray,
        order_by_rank: bool,
    ):
        """One batched pass: per node, the dispatched victim list, the
        gang-floor kept-mask, and the sufficiency prefix over the kept
        victims' request cumsum.  Returns per-node-row dicts:
        ``victims[row]`` (ordered victim indices), ``prefix[row]`` (count
        sufficient, or len(victims) when the node cannot cover — the host
        evicts them all and moves on) and ``sufficient[row]``."""
        t0 = time.perf_counter()
        cand, starts, seg_id, seg_node = self._segment_candidates(cand_mask)
        if cand.shape[0] == 0:
            self.phase["mask"] += time.perf_counter() - t0
            return {}, {}, {}
        member, _ = self._victims_masks(cand, starts, seg_id, preemptor)
        self.phase["mask"] += time.perf_counter() - t0

        t1 = time.perf_counter()
        vict = cand[member]
        seg_of = seg_id[member]
        if vict.shape[0] == 0:
            self.phase["plan"] += time.perf_counter() - t1
            return {}, {}, {}
        # Eviction order inside a node: descending builtin task order for
        # preempt (the inverted heap), dispatch/candidate order for reclaim.
        key = -self._rank[vict] if order_by_rank else self._pos[vict]
        order = np.lexsort((key, seg_of))
        vict = vict[order]
        seg_of = seg_of[order]
        # Live gang floor: per (segment, job) running count in eviction
        # order; keep while k <= occupied - min_available (min_available==1
        # jobs are gang's unlimited carve-out).  ``occupied`` is live at
        # hunt start; the in-plan decrement IS the cumulative count.
        gang_live = any(
            name == "gang" for tier in self._plugins for name, _ in tier
        )
        if gang_live:
            occ = self._occupied(self._vjob[vict])
            g = seg_of * max(len(self._job_list), 1) + self._vjob[vict]
            g_order = np.argsort(g, kind="stable")
            g_inv = np.empty_like(g_order)
            g_inv[g_order] = np.arange(g_order.shape[0])
            ones = np.ones(vict.shape[0], dtype=np.int64)
            csum = np.add.accumulate(ones)
            g_starts = np.nonzero(np.diff(g[g_order], prepend=-1))[0]
            off = np.zeros_like(csum)
            off[g_starts] = csum[g_starts] - 1
            np.maximum.accumulate(off, out=off)
            k = (csum - off)[g_inv]  # 1-based within (segment, job)
            ma = self._min_avail[self._vjob[vict]]
            kept = (ma == 1) | (k <= occ[self._vjob[vict]] - ma)
        else:
            kept = np.ones(vict.shape[0], dtype=bool)

        victims_by_row: Dict[int, np.ndarray] = {}
        prefix_by_row: Dict[int, int] = {}
        sufficient_by_row: Dict[int, bool] = {}
        seg_starts = np.nonzero(np.diff(seg_of, prepend=-1))[0]
        bounds = list(seg_starts) + [vict.shape[0]]
        for s in range(len(seg_starts)):
            lo, hi = bounds[s], bounds[s + 1]
            row = int(self._vnode[vict[lo]])
            # The plan offers the KEPT victims only: the host hunt's
            # FloorGuard skips a floor-breaking victim without evicting it,
            # so the replayable sequence is exactly the kept prefix (a row
            # whose victims were ALL floor-rejected stays planned with an
            # empty offer — the host visits it and evicts nothing).
            seg_vict = vict[lo:hi][kept[lo:hi]]
            victims_by_row[row] = seg_vict
            if seg_vict.shape[0] == 0:
                prefix_by_row[row] = 0
                sufficient_by_row[row] = False
                continue
            cum = np.add.accumulate(self._req[seg_vict], axis=0)
            ok = np.all(
                (resreq[None, :] < cum)
                | (np.abs(cum - resreq[None, :]) < self._mins[None, :]),
                axis=1,
            )
            hit = np.nonzero(ok)[0]
            if hit.shape[0]:
                prefix_by_row[row] = int(hit[0]) + 1
                sufficient_by_row[row] = True
            else:
                prefix_by_row[row] = seg_vict.shape[0]
                sufficient_by_row[row] = False
        self.phase["plan"] += time.perf_counter() - t1
        return victims_by_row, prefix_by_row, sufficient_by_row

    def _pick_first(
        self, n_ordered: int, start: int, row_pos: Dict[int, int],
        sufficient_rows: Dict[int, bool],
    ) -> int:
        """The earliest sweep-order position holding a SUFFICIENT plan: the
        numpy argmin of the JAX package's single-device branch (its mesh
        branch, ``sharded_victim_pick``, waits for the port's mesh, so
        ``device_picks`` stays 0).  The walk still visits earlier victim-
        bearing-but-insufficient nodes (the evict-all-and-continue host
        behavior) and re-checks the live node gate."""
        pos = np.full(max(n_ordered, 1), np.inf, dtype=np.float64)
        for row, ok in sufficient_rows.items():
            i = row_pos.get(row, -1)
            if ok and i >= start:
                pos[i] = float(i)
        best = int(np.argmin(pos))
        return best if np.isfinite(pos[best]) else -1

    # -- hunts ----------------------------------------------------------------

    def _task_view(self, v: int):
        job = self.ssn.jobs[self._jobs[v]]
        return job.view_for_row(int(self._job_rows[v]))

    def hunt_preempt(
        self, stmt, preemptor, preemptor_job, ordered, sweep,
        pod_count_live: bool, same_job: bool,
    ) -> bool:
        """The device twin of ``PreemptAction._preempt``: batched plan,
        Statement replay.  Mirrors the host hunt exactly — including the
        evict-all-and-continue behavior on a validated node whose victims
        cannot cover the request (state then changed, so the remaining
        sweep re-plans on the live ledgers)."""
        self.counters["hunts"] += 1
        ordered_rows, row_pos = self._ordered_node_rows(ordered)
        pq = self._queue_idx.get(preemptor_job.queue, -1)
        pj = self._job_idx.get(preemptor.job, -2)
        resreq = np.zeros(self._req.shape[1])
        arr = preemptor.init_resreq.array
        w = min(arr.shape[0], resreq.shape[0])
        resreq[:w] = arr[:w]
        if preemptor.init_resreq.has_scalars or preemptor.resreq.has_scalars:
            # Scalar preemptors flip Resource.Less map-presence branches the
            # engine does not model; the gate normally catches this at
            # prime, but requests can differ per task.
            raise _FallbackHunt()

        start = 0
        while start < ordered_rows.shape[0]:
            alive = self._alive()
            if same_job:
                cand_mask = alive & (self._vjob == pj)
            else:
                cand_mask = (
                    alive & (self._vqueue == pq) & (self._vjob != pj)
                )
            victims_by_row, prefix_by_row, sufficient_by_row = (
                self._plan_segments(
                    preemptor, cand_mask, resreq, order_by_rank=True,
                )
            )
            if not victims_by_row:
                return False
            # The pick decides where this plan iteration pipelines: the
            # earliest sweep position holding a sufficient plan.  Positions
            # past it are consulted only when the live node gate rejects
            # the winner — there the per-row masks take back over.
            first_ok = self._pick_first(
                ordered_rows.shape[0], start, row_pos, sufficient_by_row
            )
            # Victim-bearing sweep positions only — the walk never probes
            # a node the batched masks proved victimless.
            positions = sorted(
                p for row in victims_by_row
                if (p := row_pos.get(row, -1)) >= start
            )
            progressed = False
            for i in positions:
                row = int(ordered_rows[i])
                node = ordered[i]
                if pod_count_live and not sweep.node_open(node):
                    continue
                victims = victims_by_row[row]
                prefix = prefix_by_row[row]
                self.counters["planned_nodes"] += 1
                # Same observability signals the host walk emits per probed
                # node (actions/preempt.py): the planned victim count and
                # the attempt mark — flavor=device must not flatline the
                # preemption dashboards.
                metrics.update_preemption_victims_count(len(victims))
                t0 = time.perf_counter()
                evicted_any = self._replay_evictions(stmt, victims, prefix)
                self.phase["replay"] += time.perf_counter() - t0
                metrics.register_preemption_attempts()
                if i == first_ok or (
                    i > first_ok >= 0 and sufficient_by_row.get(row, False)
                ):
                    t0 = time.perf_counter()
                    stmt.pipeline(preemptor, node.name)
                    self.phase["replay"] += time.perf_counter() - t0
                    self.counters["pipelined"] += 1
                    self.counters["segments"] += 1
                    return True
                # Insufficient: the host evicts every offered victim and
                # moves to the next node.  Only a node that actually
                # changed state forces a re-plan.
                if evicted_any:
                    self.counters["segments"] += 1
                    start = i + 1
                    progressed = True
                    break
            if not progressed:
                return False
        return False

    def _replay_evictions(self, stmt, victims: np.ndarray, prefix: int) -> bool:
        """stmt.evict the plan's victims in order (the gang floor is already
        folded into the kept-prefix).  Returns True when anything evicted."""
        n = 0
        for v in victims.tolist():
            if n >= prefix:
                break
            task = self._task_view(v)
            if task.status != TaskStatus.RUNNING:
                continue
            # The kept-mask enforced the floor vectorized; tasks whose job
            # state moved since the gather were filtered by ``alive``.
            logger.info(
                "preempting task %s (device plan)", task.uid
            )
            stmt.evict(task, self.kind)
            self.counters["evictions"] += 1
            n += 1
        return n > 0

    def next_reclaim_node(
        self, task, job, ordered, start: int, sweep, pod_count_live: bool,
    ):
        """The device twin of the reclaim hunt's node walk: the first node
        at/after ``start`` whose dispatched victim set is non-empty (and
        which passes the live node gate), with the gang-floor-guarded
        sufficiency prefix.  Returns (node, victims, chosen_k, next_start)
        or None; the ACTION replays (bulk evict + top-up + pipeline), then
        calls again if unsatisfied — masks recompute on the live ledgers."""
        self.counters["hunts"] += start == 0
        ordered_rows, row_pos = self._ordered_node_rows(ordered)
        q = self._queue_idx.get(job.queue, -1)
        resreq = np.zeros(self._req.shape[1])
        arr = task.init_resreq.array
        w = min(arr.shape[0], resreq.shape[0])
        resreq[:w] = arr[:w]
        if task.init_resreq.has_scalars or task.resreq.has_scalars:
            raise _FallbackHunt()

        alive = self._alive()
        cand_mask = alive & (self._vqueue != q) & (self._vqueue >= 0)
        victims_by_row, prefix_by_row, sufficient_by_row = self._plan_segments(
            task, cand_mask, resreq, order_by_rank=False,
        )
        if not victims_by_row:
            return None
        # Reclaim drains insufficient nodes too (the action tops up), so
        # the pick selects the first victim-BEARING sweep position — the
        # device winner heads the walk; later positions are consulted only
        # when the live node gate rejects it.
        first = self._pick_first(
            ordered_rows.shape[0], start, row_pos,
            {row: True for row in victims_by_row},
        )
        if first < 0:
            return None
        tail = sorted(
            p for row in victims_by_row
            if (p := row_pos.get(row, -1)) > first
        )
        for i in (first, *tail):
            row = int(ordered_rows[i])
            victims = victims_by_row[row]
            node = ordered[i]
            if pod_count_live:
                if not sweep.node_open(node):
                    continue
            else:
                try:
                    self.ssn.predicate_fn(task, node)
                except Exception:
                    continue
            self.counters["planned_nodes"] += 1
            self.counters["segments"] += 1
            views = [self._task_view(int(v)) for v in victims.tolist()]
            return node, views, prefix_by_row[row], i + 1
        return None

    def note_discard(self, stmt) -> None:
        """Call BEFORE ``stmt.discard()``: the rollback's ``_unevict`` walks
        the recorded ops in reverse and each ``update_task`` re-appends the
        restored victim at the END of its node's task map — the candidate
        order the next host dispatch would see.  Mirror it in the captured
        ``pos`` keys so later hunts segment identically."""
        uid_to_v = self._uid_to_v
        for name, args in reversed(stmt.operations):
            if name != "evict":
                continue
            v = uid_to_v.get(args[0].uid)
            if v is not None:
                self._pos[v] = self._pos_counter
                self._pos_counter += 1

    def note_commit(self, ops: list) -> None:
        """Call with a pre-commit snapshot of ``stmt.operations``: an evict
        whose RPC failed is restored by ``_unevict`` (again moving to the
        end of the node map); re-sync those positions from the live store
        status."""
        uid_to_v = self._uid_to_v
        for name, args in ops:
            if name != "evict":
                continue
            v = uid_to_v.get(args[0].uid)
            if v is None:
                continue
            row = int(self._job_rows[v])
            job = self.ssn.jobs.get(self._jobs[v])
            if job is None or row < 0:
                continue
            if job.store.status[row] == int(TaskStatus.RUNNING):
                self._pos[v] = self._pos_counter
                self._pos_counter += 1

    def note_evictions(self, n: int) -> None:
        """Reclaim replay evidence (the action owns the bulk evict)."""
        self.counters["evictions"] += n

    # -- evidence --------------------------------------------------------------

    def stats(self) -> dict:
        """The ``run_stats()['evict']`` block: flavor, engagement (or the
        fallback reason), hunt counters and the score/mask/plan/replay
        phase split — routed ``phases.note("evict")`` by the actions into
        bench ``detail.cycles[].evict``."""
        if not self.active:
            return {
                "flavor": self.flavor, "kind": self.kind, "engaged": False,
                "reason": self._reason or "inactive",
            }
        out = {
            "flavor": self.flavor, "kind": self.kind, "engaged": True,
            "victims_tracked": len(self._uids),
        }
        out.update(self.counters)
        out["phase"] = {k: round(v, 6) for k, v in self.phase.items()}
        return out


class _FallbackHunt(Exception):
    """Raised mid-hunt when a task's requests leave the engine's modeled
    domain (scalar resources); the action falls back to the host hunt for
    that task."""


def note_evidence(kind: str, stats: dict) -> None:
    """Merge one action's evict evidence into the cycle's ``evict`` note
    (preempt and reclaim both run per cycle; the note carries both)."""
    from scheduler_tpu_torch.utils import phases

    if not phases.active():
        return
    cur = dict(phases.get_note("evict") or {})
    cur[kind] = stats
    phases.note("evict", cur)
