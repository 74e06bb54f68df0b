"""Backfill's device flavor: the batched BestEffort class engine
(``scheduler_tpu/ops/backfill.py:88-616``).

The reference's backfill is a per-task, per-node Python sweep — for every
zero-request (BestEffort) pending task, walk the node list, run the tiered
predicate dispatch with exceptions as control flow, bind at the first pass
(``actions/backfill.py`` ``_sweep``, reference ``backfill.go``).  That is
O(T x N) interpreter work, and on a saturated cluster almost all of it is
spent proving tasks UNPLACEABLE.  Under ``SCHEDULER_TORCH_BACKFILL=device``
this module re-expresses the sweep as class-level batched math:

* a **class mask** ``[S, N]``: every registered static predicate evaluated
  once per (signature class, node) instead of once per (task, node) — the
  class notion is ``megakernel.request_signature_ids`` +
  ``sig_compress.derive_classes`` (req/init rows are all-zero for
  BestEffort, so classes collapse to the static-predicate signature).  The
  predicates plugin's device builder makes the rows with the
  static-predicate kernel (``csrc/static_predicate_mask.cu`` on the card);
* the **one live gate** folded in: per-node pod-count room
  (``pods_limit - len(node.tasks)``), monotone during backfill because
  backfill only ADDS pods;
* a **multiplicity-weighted capacity replay** per run of consecutive
  same-class tasks: a run of k same-class tasks takes
  ``clip(k - prior, 0, mask_row * room)`` per node (the masked-capacity
  water-fill) — the outcome of k consecutive host sweeps, because within a
  run no other class binds and room only falls.  Runs break at class
  changes AND at dynamic-predicate tasks, so interleavings replay in exact
  host order.  The fill is a vectorized numpy pass, as in the JAX
  package's single-device branch (below a device round trip); its mesh
  fill (``sharded_backfill_fill``) waits for the port's mesh.

The plan replays **transactionally** through ``ssn.allocate``: a bind
failure falls that one task back to the exact host sweep (the failed
node's error pre-recorded, never retried for the SAME task — the host
rule), and the remaining runs re-solve against live room, so the
first-bind-failure retry boundary holds by reconstruction.

``FitErrors`` for unplaceable tasks are reconstructed from the class mask
so the per-node record stays the reference's: room-exhausted nodes get the
host's ``NODE_POD_NUMBER_EXCEEDED`` (pod count is checked FIRST in the
host chain), statically-failing nodes get the host predicate's own error by
calling ``ssn.static_predicate_fn`` once per (run, node) — one record is
shared by every unplaceable task of a run (``FitErrors.error()``
aggregates task-name-free).

Exactness gate: the engine engages only when it can model the session
exactly — every registered predicate signature-static
(``predicate_fns`` a subset of ``static_predicate_fns``), enabled predicate
plugins within {predicates}, device mask builders within {predicates,
nodeorder}.  Anything else records a decline reason in the evidence block
and runs the unchanged host sweep; host-port / inter-pod-affinity tasks
opt out individually and are host-swept inline at their exact position.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.api.unschedule_info import (
    NODE_POD_NUMBER_EXCEEDED, FitError, FitErrors,
)
from scheduler_tpu_torch.apis.objects import PodGroupPhase
from scheduler_tpu_torch.utils.scheduler_helper import get_node_list
from scheduler_tpu_torch.utils.sweep import static_predicate_sig

logger = logging.getLogger("scheduler_tpu_torch.backfill")


def backfill_flavor() -> str:
    """The backfill flavor: ``host`` (default, the reference per-task sweep
    with cohort fast-start) or ``device`` (the batched class engine), from
    ``SCHEDULER_TORCH_BACKFILL``.  The allocate engine never reads it, so
    it is not part of the engine cache's key."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_BACKFILL", "host", choices=("host", "device"))


def enabled_predicate_plugins(ssn) -> tuple:
    """Plugin names whose predicate is registered AND tier-enabled, in
    dispatch order — the set ``ssn.predicate_fn`` actually runs (the
    ``SweepCache`` applicability rule), which is what the engine must
    model, not the raw registry."""
    out: List[str] = []
    for tier in ssn.tiers:
        for plugin in tier.plugins:
            if not plugin.predicate_enabled():
                continue
            if plugin.name in ssn.predicate_fns and plugin.name not in out:
                out.append(plugin.name)
    return tuple(out)


def pod_count_gated(ssn) -> bool:
    """Whether the pod-count gate is live — same applicability rule as
    ``utils/sweep.py`` ``SweepCache``: the predicates plugin registered a
    predicate and is enabled in some tier.  Without it the host chain never
    checks pod count and the first predicate-passing node absorbs every
    BestEffort task."""
    return "predicates" in ssn.predicate_fns and any(
        plugin.name == "predicates" and plugin.predicate_enabled()
        for tier in ssn.tiers
        for plugin in tier.plugins
    )


def _static_signature_ids(st, t: int) -> np.ndarray:
    """Dense STATIC-signature ids of the snapshot's first ``t`` tasks:
    tasks sharing (selector row, toleration row, unknown flag, affinity
    spec) share one [N] static mask/score row.  Sound only for the builtin
    device builders (predicates, nodeorder), whose contributions are pure
    functions of exactly these columns; both callers gate on that
    (``FusedAllocator._static_signature_ids`` and this module's exactness
    gate)."""
    from scheduler_tpu_torch.api.job_info import unique_row_codes

    sel = st.tasks.selector[:t]
    tol = st.tasks.tolerated[:t]
    hu = st.tasks.has_unknown_selector[:t]
    req_aff = st.tasks.req_aff[:t]
    pref_aff = st.tasks.pref_aff[:t]
    cols = [hu[:, None]]
    if sel.shape[1]:
        cols.insert(0, sel)
    if tol.shape[1]:
        cols.append(tol)
    codes, _ = unique_row_codes(np.hstack(cols).astype(np.uint8))
    _, base_ids = np.unique(codes, return_inverse=True)
    aff_rows = req_aff | pref_aff
    if not aff_rows.any():
        return base_ids.astype(np.int32)
    # Only affinity-carrying rows need the Python walk (their static rows
    # depend on the affinity SPEC, keyed by value-based dataclass repr).
    combined = base_ids.astype(np.int64)
    offset = int(base_ids.max()) + 1
    key_of: dict = {}
    cores = st.tasks.cores
    for i in np.nonzero(aff_rows)[0].tolist():
        pod = cores[i].pod
        key = (int(base_ids[i]), repr(pod.affinity) if pod is not None else "")
        sid = key_of.get(key)
        if sid is None:
            sid = key_of[key] = offset + len(key_of)
        combined[i] = sid
    _, sids = np.unique(combined, return_inverse=True)  # densify
    return sids.astype(np.int32)


def _solve_runs(
    rows: np.ndarray, room: np.ndarray, counts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The masked-capacity water-fill, host reference: for each run r (in
    order), each node takes ``clip(counts[r] - prior, 0, mask * room)``
    where ``prior`` is the masked-capacity prefix sum — the multiplicity-
    weighted form of ``counts[r]`` consecutive first-passing-node sweeps.
    Returns (takes [R, N], placed [R]); room is consumed run to run, never
    mutated in place."""
    r_n, n = rows.shape
    takes = np.zeros((r_n, n), dtype=np.int64)
    placed = np.zeros(r_n, dtype=np.int64)
    cur = room.astype(np.int64).copy()
    for r in range(r_n):
        cap = np.where(rows[r], cur, 0)
        cum = np.cumsum(cap)
        prior = cum - cap
        take = np.clip(counts[r] - prior, 0, cap)
        takes[r] = take
        placed[r] = min(int(counts[r]), int(cum[-1]) if n else 0)
        cur -= take
    return takes, placed


class BackfillEngine:
    """One backfill action's device engine: gate, class mask, run solve,
    transactional replay.  Built fresh per action (like ``EvictEngine``,
    never resident in the engine cache — the snapshot it masks is this
    cycle's)."""

    def __init__(self, ssn) -> None:
        self.ssn = ssn
        self.flavor = backfill_flavor()
        self.lp_noop = False  # no LP flavor in this package: always False
        self._reason: Optional[str] = None
        self._enabled: tuple = ()
        self._nodes: list = []
        self._class_mask = np.zeros((0, 0), dtype=bool)
        self._check_pod = False
        self._room_sentinel = 0
        self.counters: Dict[str, int] = {
            "tasks": 0, "classes": 0, "dynamic_tasks": 0, "segments": 0,
            "runs": 0, "device_solves": 0, "resolves": 0,
            "device_binds": 0, "host_binds": 0, "bind_failures": 0,
            "unplaceable": 0, "predicate_calls_host": 0,
        }
        self.phase: Dict[str, float] = {"mask": 0.0, "solve": 0.0,
                                        "replay": 0.0}
        self._check_active()

    # -- the exactness gate ---------------------------------------------------

    def _check_active(self) -> None:
        ssn = self.ssn
        if self.flavor != "device":
            self._reason = "flavor host"
            return
        self._enabled = enabled_predicate_plugins(ssn)
        # The ISSUE-level whole-hog rule, identical to the host fast-start's
        # soundness condition: every REGISTERED predicate must carry a
        # static twin, or prefix proofs (and class masks) are unsound.
        non_static = sorted(set(ssn.predicate_fns) - set(ssn.static_predicate_fns))
        if non_static:
            self._reason = (
                "predicates without static twins: " + ", ".join(non_static)
            )
            return
        extra = [n for n in self._enabled if n != "predicates"]
        if extra:
            self._reason = "unmodeled predicate plugins: " + ", ".join(extra)
            return
        foreign = sorted(
            (set(ssn.device_predicates) | set(ssn.device_scorers))
            - {"predicates", "nodeorder"}
        )
        if foreign:
            # The _static_signature_ids soundness set (ops/fused.py): a
            # foreign builder's mask may not be a function of the static
            # signature columns, so class rows could not stand for tasks.
            self._reason = (
                "unmodeled device mask builders: " + ", ".join(foreign)
            )
            return
        if "predicates" in self._enabled and "predicates" not in ssn.device_predicates:
            self._reason = "predicates plugin published no device mask"
            return

    @property
    def active(self) -> bool:
        return self._reason is None

    # -- build: population, mask, classes -------------------------------------

    def _population(self) -> list:
        """(job, task, dynamic) triples in EXACT host iteration order —
        the job dict walk, the PENDING-status index, the BestEffort filter
        (``actions/backfill.py``).  ``dynamic`` marks the per-task opt-out:
        host-port / inter-pod-affinity pods (``static_predicate_sig`` None,
        the SweepCache carve-out) are host-swept inline at their position."""
        ssn = self.ssn
        dyn_uids = getattr(ssn, "device_dynamic_task_uids", None) or set()
        population = []
        for job in list(ssn.jobs.values()):
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            for task in list(job.task_status_index.get(TaskStatus.PENDING, {}).values()):
                if not task.init_resreq.is_empty():
                    continue  # only BestEffort tasks backfill
                dyn = task.uid in dyn_uids or static_predicate_sig(task) is None
                population.append((job, task, dyn))
        return population

    def _task_mask(self, st, rep_rows: np.ndarray) -> np.ndarray:
        """[S, N] static mask rows of the class representatives: the
        plugin-independent node-ready base AND each enabled device
        predicate builder (the ``ops/allocator.py`` fold), run as
        ``build(st, device)`` on the session's device.  The representatives'
        rows are gathered there before the one copy to the host, so only
        [S, N] crosses, not the [T', N] mask; the rows are the same either
        way.  Without the predicates plugin enabled the host chain enforces
        NOTHING (the reference behavior), so the mask is all-true, not
        ready-gated."""
        import torch

        from scheduler_tpu_torch.ops.device import resolve_device
        from scheduler_tpu_torch.ops.predicates import base_static_mask

        s = rep_rows.shape[0]
        if "predicates" not in self._enabled:
            return np.ones((s, st.nodes.count), dtype=bool)
        device = resolve_device(getattr(self.ssn, "device", None))
        ready = torch.from_numpy(np.ascontiguousarray(st.nodes.ready, dtype=bool)).to(device)
        rows = base_static_mask(s, ready)
        idx = torch.as_tensor(rep_rows, dtype=torch.int64, device=device)
        for name, build in self.ssn.device_predicates.items():
            if name not in self._enabled:
                continue
            contrib = build(st, device)
            if contrib is not None:
                rows = rows & contrib[idx]
        return rows.cpu().numpy().astype(bool)

    def _classes(self, st, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """(class id per task, representative row per class) via the shared
        signature chain: ``request_signature_ids`` over the (req, init)
        rows — all-zero for BestEffort, so this collapses as expected —
        then ``derive_classes`` folding in the static signature, queue and
        priority (the cohort class notion).  The cohort path scales request columns
        first; scaling is a positive per-column multiplier (row-equality
        invariant), a no-op on zero rows, and is skipped here."""
        from scheduler_tpu_torch.ops.megakernel import request_signature_ids
        from scheduler_tpu_torch.ops.sig_compress import derive_classes

        req_s = np.ascontiguousarray(np.asarray(st.tasks.resreq[:t], np.float32))
        init_s = np.ascontiguousarray(
            np.asarray(st.tasks.init_resreq[:t], np.float32)
        )
        inverse, _ = request_signature_ids(req_s, init_s)
        static_sids = _static_signature_ids(st, t)
        jidx = st.tasks.job_idx[:t]
        sig_of_task, _, rep_rows = derive_classes(
            inverse, static_sids,
            np.asarray(st.jobs.queue_idx)[jidx],
            np.asarray(st.jobs.priority)[jidx],
        )
        return np.asarray(sig_of_task, np.int64), np.asarray(rep_rows, np.int64)

    def _snapshot(self, static: list):
        """The snapshot tensors of the static sub-population, given as
        ``(job, task)`` pairs in host order: the columnar builder's
        ``(job, rows)`` input, one pair for each run of consecutive same-job
        tasks (the population is job-major)."""
        from scheduler_tpu_torch.api.tensors import build_snapshot_tensors_columnar

        ssn = self.ssn
        per_job: list = []
        for job, task in static:
            if not per_job or per_job[-1][0] is not job:
                per_job.append((job, []))
            per_job[-1][1].append(job.request_matrices()[2][task.uid])
        vocab = next(iter(ssn.nodes.values())).vocab
        return build_snapshot_tensors_columnar(
            self._nodes, list(ssn.jobs.values()),
            [(job, np.asarray(rows, dtype=np.int64)) for job, rows in per_job],
            sorted(ssn.queues), vocab,
        )

    def _prepare(self, population: list) -> np.ndarray:
        """Build the [S, N] class mask for the static sub-population;
        returns the per-static-task class ids (host order)."""
        t0 = time.perf_counter()
        static = [(job, task) for job, task, dyn in population if not dyn]
        self.counters["dynamic_tasks"] = len(population) - len(static)
        sig_of_task = np.zeros(0, dtype=np.int64)
        if static:
            st = self._snapshot(static)
            t = len(static)
            sig_of_task, rep_rows = self._classes(st, t)
            self._class_mask = self._task_mask(st, rep_rows)
            self.counters["classes"] = int(self._class_mask.shape[0])
        else:
            self._class_mask = np.zeros((0, len(self._nodes)), dtype=bool)
        self.phase["mask"] += time.perf_counter() - t0
        return sig_of_task

    def _live_room(self) -> np.ndarray:
        """Per-node pod room from LIVE node state — re-read at every solve
        and reconstruction so binds (device, host-fallback and dynamic
        alike) are always reflected; when the pod-count gate is off the
        room is an absorbing sentinel (the first mask-passing node takes
        everything, the host behavior without the gate)."""
        if self._check_pod:
            return np.array(
                [max(n.pods_limit - len(n.tasks), 0) for n in self._nodes],
                dtype=np.int64,
            )
        return np.full(len(self._nodes), self._room_sentinel, dtype=np.int64)

    # -- the engine run -------------------------------------------------------

    def run(self) -> None:
        """The whole device backfill: population, class mask, segment/run
        solve, transactional replay.  Binds bitwise-identical to the host
        sweep (tests/test_backfill_parity.py)."""
        ssn = self.ssn
        population = self._population()
        self.counters["tasks"] = len(population)
        if not population:
            return
        self._nodes = get_node_list(ssn.nodes)
        self._room_sentinel = len(population)
        if not self._nodes:
            # The host sweep over an empty node list: every task records an
            # empty FitErrors.
            for job, task, _ in population:
                job.nodes_fit_errors[task.uid] = FitErrors()
                self.counters["unplaceable"] += 1
            return
        self._check_pod = pod_count_gated(ssn)
        sig = self._prepare(population)
        seq = []
        si = 0
        for job, task, dyn in population:
            if dyn:
                seq.append((job, task, None))
            else:
                seq.append((job, task, int(sig[si])))
                si += 1
        self._run_segments(seq)

    def _run_segments(self, seq: list) -> None:
        """Walk the host-order sequence: dynamic tasks host-sweep inline;
        maximal dynamic-free stretches solve as run lists."""
        i, n_seq = 0, len(seq)
        while i < n_seq:
            if seq[i][2] is None:
                job, task, _ = seq[i]
                self._host_task(job, task)
                i += 1
                continue
            j = i
            runs: list = []  # [class id, [(job, task), ...]]
            while j < n_seq and seq[j][2] is not None:
                cls = seq[j][2]
                if not runs or runs[-1][0] != cls:
                    runs.append([cls, []])
                runs[-1][1].append((seq[j][0], seq[j][1]))
                j += 1
            self.counters["segments"] += 1
            self.counters["runs"] += len(runs)
            self._fill_runs(runs)
            i = j

    def _solve(
        self, cls_ids: np.ndarray, counts: np.ndarray, room: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The run list's water-fill: the host reference ``_solve_runs``
        (the JAX package's single-device branch; its mesh fill,
        ``sharded_backfill_fill``, waits for the port's mesh)."""
        return _solve_runs(self._class_mask[cls_ids], room, counts)

    def _fill_runs(self, runs: list) -> None:
        """Solve + replay one segment's run list; a bind failure falls that
        task to the host sweep and RE-SOLVES the remainder against live
        room (the failed node's room never fell, so the next same-class
        task retries it — the host ``min(won, bind_fail)`` boundary by
        reconstruction)."""
        while runs:
            room = self._live_room()
            t0 = time.perf_counter()
            cls_ids = np.asarray([r[0] for r in runs], dtype=np.int64)
            counts = np.asarray([len(r[1]) for r in runs], dtype=np.int64)
            takes, placed = self._solve(cls_ids, counts, room)
            self.phase["solve"] += time.perf_counter() - t0
            self.counters["device_solves"] += 1
            resume = None  # (run index, next member index) after a bind failure
            t0 = time.perf_counter()
            for r, (cls, members) in enumerate(runs):
                take = takes[r]
                filled = np.nonzero(take)[0]
                # node index per placed member, ascending node order — the
                # first-passing-node order the host sweep binds in
                order = np.repeat(filled, take[filled])
                shared_fe: Optional[FitErrors] = None
                for k, (job, task) in enumerate(members):
                    if k < order.shape[0]:
                        node = self._nodes[int(order[k])]
                        try:
                            self.ssn.allocate(task, node.name)
                        except Exception as err:
                            logger.error(
                                "backfill bind of %s on %s failed: %s",
                                task.uid, node.name, err,
                            )
                            self.counters["bind_failures"] += 1
                            self.phase["replay"] += time.perf_counter() - t0
                            self._host_task(
                                job, task, prefail=(int(order[k]), err)
                            )
                            t0 = time.perf_counter()
                            resume = (r, k + 1)
                            break
                        self.counters["device_binds"] += 1
                    else:
                        # Unplaceable: ONE reconstructed record per run,
                        # shared — within a run no other class binds, so
                        # room is frozen once placements stop and every
                        # member sees the identical per-node outcome
                        # (docs/BACKFILL.md "Unplaceable records").
                        if shared_fe is None:
                            shared_fe = self._reconstruct_fit_errors(
                                int(cls), task
                            )
                        job.nodes_fit_errors[task.uid] = shared_fe
                        self.counters["unplaceable"] += 1
                if resume is not None:
                    break
            self.phase["replay"] += time.perf_counter() - t0
            if resume is None:
                return
            r, k = resume
            rest = []
            if k < len(runs[r][1]):
                rest.append([runs[r][0], runs[r][1][k:]])
            rest.extend(runs[r + 1:])
            runs = rest
            self.counters["resolves"] += 1

    def _host_task(self, job, task, prefail=None) -> None:
        """The exact host sweep for one task, from node zero (complete
        per-node FitErrors record — the host's own total-fallback shape).
        ``prefail``: a (node index, error) this task ALREADY failed to bind
        on during replay; recorded, never re-attempted — the host rule (a
        task continues past its own bind failure, it does not retry it)."""
        t0 = time.perf_counter()
        ssn = self.ssn
        fe = FitErrors()
        won = None
        pre_idx = prefail[0] if prefail is not None else None
        for idx, node in enumerate(self._nodes):
            if pre_idx is not None and idx == pre_idx:
                fe.set_node_error(node.name, prefail[1])
                continue
            self.counters["predicate_calls_host"] += 1
            try:
                ssn.predicate_fn(task, node)
            except Exception as err:
                fe.set_node_error(node.name, err)
                continue
            try:
                ssn.allocate(task, node.name)
            except Exception as err:
                logger.error(
                    "backfill bind of %s on %s failed: %s",
                    task.uid, node.name, err,
                )
                fe.set_node_error(node.name, err)
                self.counters["bind_failures"] += 1
                continue
            won = idx
            break
        if won is None:
            job.nodes_fit_errors[task.uid] = fe
            self.counters["unplaceable"] += 1
        else:
            self.counters["host_binds"] += 1
        self.phase["replay"] += time.perf_counter() - t0

    def _reconstruct_fit_errors(self, cls: int, task) -> FitErrors:
        """Reference-complete per-node record for an unplaceable run,
        rebuilt from the device mask + live room in HOST reason order: pod
        count first (the host chain checks it before anything static), then
        the static predicate's own error, fetched by ONE host call per
        statically-failing node.  A node the mask passes with room left
        cannot exist for an unplaceable run; if drift ever produces one,
        the full host chain is consulted so the record carries the host
        reason (and the parity suite surfaces the drift as a lost bind)."""
        ssn = self.ssn
        fe = FitErrors()
        row = self._class_mask[cls]
        room = self._live_room()
        for idx, node in enumerate(self._nodes):
            if self._check_pod and room[idx] <= 0:
                fe.set_node_error(node.name, FitError(
                    task.name, node.name, NODE_POD_NUMBER_EXCEEDED,
                ))
                continue
            self.counters["predicate_calls_host"] += 1
            if row[idx]:
                try:
                    ssn.predicate_fn(task, node)
                except Exception as err:
                    fe.set_node_error(node.name, err)
                continue
            try:
                ssn.static_predicate_fn(task, node)
            except Exception as err:
                fe.set_node_error(node.name, err)
            else:
                try:
                    ssn.predicate_fn(task, node)
                except Exception as err:
                    fe.set_node_error(node.name, err)
        return fe

    # -- evidence -------------------------------------------------------------

    def stats(self) -> dict:
        """The backfill evidence block: flavor, engagement (or the decline
        reason), the lp no-op decision, sweep-ops ledger
        (``predicate_calls_host`` vs ``device_classes``) and the
        mask/solve/replay phase split — routed ``phases.note("backfill")``
        by the action into bench ``detail.cycles[].backfill``."""
        if not self.active:
            return {
                "flavor": self.flavor, "engaged": False,
                "reason": self._reason or "inactive",
                "lp_noop": bool(self.lp_noop),
            }
        out = {
            "flavor": self.flavor, "engaged": True,
            "lp_noop": bool(self.lp_noop),
        }
        out.update(self.counters)
        out["device_classes"] = self.counters["classes"]
        out["phase"] = {k: round(v, 6) for k, v in self.phase.items()}
        return out


def note_evidence(stats: dict) -> None:
    """Attach the action's backfill evidence to the open cycle (one
    backfill action per cycle; host-path counters ride the same block)."""
    from scheduler_tpu_torch.utils import phases

    if not phases.active():
        return
    cur = dict(phases.get_note("backfill") or {})
    cur.update(stats)
    phases.note("backfill", cur)
