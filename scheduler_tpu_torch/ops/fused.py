"""Fused allocate: the ENTIRE allocate action as one kernel launch, one readback.

Host shim of the mega kernel (``ops/megakernel.py``): session -> snapshot
tensors -> job and task ordering -> the kernel's staged operands -> one
launch -> decoded rows for the commit.  It mirrors the JAX package's
``FusedAllocator`` (``scheduler_tpu/ops/fused.py``) in its CURSOR-MODE mega
arm: one queue, jobs laid out in init-key order, run batching of identical
requests, cohort chunks.

Sessions that the JAX engine would run in another mode raise
``NotImplementedError`` naming the mode — releasing capacity, static [T, N]
rows, multi-queue proportion (and with it the qfair ladder), and the XLA
while-loop / step-kernel path taken when the mega gate closes.  The LP
flavor and the mesh have no switch in this package.

The device result is ONE int32[T] array encoding the whole action:
  >= 0: allocated on that node   |   -1: never reached (left pending)
  -2: first infeasible task of its job (host records FitErrors)
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scheduler_tpu_torch.api.job_info import JobInfo
from scheduler_tpu_torch.api.tensors import bucket, build_snapshot_tensors_columnar
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.ops import megakernel as _mk
from scheduler_tpu_torch.ops.allocator import (
    collect_pending,
    gang_ready_active,
    score_weights,
)
from scheduler_tpu_torch.ops.device import (
    DevicePolicy,
    pad_rows,
    resolve_device,
    scale_columns,
)
from scheduler_tpu_torch.ops.layout import SIG_REQ, STATS
from scheduler_tpu_torch.utils.scheduler_helper import (
    enabled_task_order_chain as _enabled_task_order_chain,
    task_order_builtin,
    task_sort_key as _task_sort_key,
)

logger = logging.getLogger("scheduler_tpu_torch.ops.fused")

# Result encoding (see module docstring).
UNPLACED = -1
FAILED = -2
_PIPE_BASE = -3

# Upper bound on placements per micro-step in the run-batched fast path.
MAX_BATCH = 128

# Comparators the fused job-selection chain understands, keyed by plugin name.
_KNOWN_JOB_ORDER = ("priority", "gang", "drf")


def _cohort_chunks(device: torch.device) -> int:
    """Placement chunks per cohort step: 4 on a CUDA device, 1 elsewhere.
    Codes are identical for every count."""
    return 4 if device.type == "cuda" else 1


class FusedAllocator:
    """Host shim: session -> tensors -> one mega_allocate launch -> decoded rows.

    Built fresh every cycle.  Execution is split into a non-blocking
    ``dispatch`` and a blocking ``readback`` so callers can overlap host
    work with the device."""

    def __init__(self, ssn, jobs: Sequence[JobInfo], device=None) -> None:
        self.device = resolve_device(device)
        self.ssn = ssn
        self._dev = None          # in-flight device codes (dispatch pending)
        self._dev_stats = None    # in-flight evidence counters
        self._stats_raw = None    # collected evidence of the last readback
        self._encoded = None      # decoded int32 codes of the last readback
        self._events = None       # CUDA events around the in-flight launch
        self.kernel_ms = None     # device time of the last launch (CUDA only)
        # Cohort evidence: host-side cohort table summary + chunk count.
        self.cohort_count = 0     # maximal identical-shape runs of length >= 2
        self.cohort_tasks = 0     # tasks covered by those runs
        self.cohort_spill = False  # some cohort must split across nodes
        self.cohort_chunks = _cohort_chunks(self.device)
        self.cohort_effective = 1  # chunks the kernel actually runs
        vocab = next(iter(ssn.nodes.values())).vocab
        policy = DevicePolicy(vocab)
        r = vocab.size
        scale = policy.column_scale(r)

        def rvec(resource) -> np.ndarray:
            out = np.zeros(r)
            arr = resource.array
            out[: arr.shape[0]] = arr
            return out

        # --- session-level dispatch config (needed before job sorting) ------
        self.weights = score_weights(ssn)
        self.comparators = tuple(
            name
            for tier in ssn.tiers
            for plugin in tier.plugins
            if plugin.job_order_enabled() and (name := plugin.name) in ssn.job_order_fns
        )
        self.queue_comparators = tuple(
            name
            for tier in ssn.tiers
            for plugin in tier.plugins
            if plugin.queue_order_enabled()
            and (name := plugin.name) in ssn.queue_order_fns
        )
        self.overused_gate = any(
            plugin.name in ssn.overused_fns
            for tier in ssn.tiers
            for plugin in tier.plugins
        )

        queue_names = sorted(
            ssn.queues, key=lambda q: (ssn.queues[q].creation_timestamp, q)
        )
        self.queue_uids = queue_names
        queue_pos = {q: i for i, q in enumerate(queue_names)}
        single_queue = (
            len(queue_names) == 1
            and not self.queue_comparators
            and not self.overused_gate
        )

        # --- jobs + flat tasks (job-major, task order within job) -----------
        # Jobs are laid out in INIT-KEY ORDER: sorted by the comparator
        # chain's values at session open (then creation/uid, empties last).
        # Among never-yet-selected jobs every chain key is frozen, so this
        # order IS the loop's first-visit order, which lets the kernel select
        # by cursor (and batch runs of identical single-task jobs).
        in_jobs: List[JobInfo] = list(jobs)

        # Ready-break deficit: only meaningful when gang's job_ready veto is
        # live; otherwise the break fires after every placement (deficit 0).
        gang_break = gang_ready_active(ssn)

        if task_order_builtin(ssn):
            use_priority = "priority" in _enabled_task_order_chain(ssn)

            def pending_rows(job: JobInfo) -> np.ndarray:
                return job.pending_rows_sorted(use_priority)
        else:
            sort_key = _task_sort_key(ssn)

            def pending_rows(job: JobInfo) -> np.ndarray:
                row_of = job.store.row_of
                return np.asarray(
                    [row_of[t.uid] for t in collect_pending(job, sort_key)],
                    dtype=np.int64,
                )

        # Jobs with nothing pending are never selectable: drop them here.
        pairs = [
            (job, rows)
            for job in in_jobs
            if (rows := pending_rows(job)).shape[0] > 0
        ]
        in_jobs = [job for job, _ in pairs]
        rows_l = [rows for _, rows in pairs]
        j = len(in_jobs)
        nums_j = np.asarray([len(rw) for rw in rows_l], dtype=np.int32)
        prio_j = np.asarray([int(job.priority) for job in in_jobs], dtype=np.int32)
        gang_j = np.asarray(
            [job.min_available - job.ready_task_num() for job in in_jobs],
            dtype=np.int32,
        )
        alloc_j = (
            np.stack([rvec(job.allocated) for job in in_jobs])
            if j
            else np.zeros((0, r), dtype=np.float64)
        )
        # Same fallback key as the host heap (Session.job_tie_key).
        tiebreak_j = np.empty(j, dtype=np.int32)
        tiebreak_j[
            sorted(range(j), key=lambda k: ssn.job_tie_key(in_jobs[k]))
        ] = np.arange(j, dtype=np.int32)

        if j:
            chain_keys: List[np.ndarray] = []
            for name in self.comparators:
                if name == "priority":
                    chain_keys.append(-prio_j)
                elif name == "gang":
                    chain_keys.append((gang_j <= 0).astype(np.int32))
                elif name == "drf":
                    # EXACTLY the kernel's arithmetic — scaled float32 over
                    # the same column-summed totals, summed in sorted-name
                    # row order — so the pre-sort ranks like the kernel's
                    # own keys.
                    ledger = getattr(ssn.nodes, "ledger", None)
                    if ledger is not None:
                        if ledger.r < r:
                            ledger.widen(r)
                        alloc_mat = ledger.allocatable[ledger.sorted_rows()][:, :r]
                    else:
                        node_sorted = sorted(ssn.nodes.values(), key=lambda nd: nd.name)
                        alloc_mat = np.zeros((len(node_sorted), r))
                        for ni, nd in enumerate(node_sorted):
                            arr = nd.allocatable.array
                            alloc_mat[ni, : arr.shape[0]] = arr
                    totals_s = scale_columns(alloc_mat.sum(axis=0)[None, :], scale)[0]
                    alloc_s = scale_columns(alloc_j, scale)
                    safe = np.where(totals_s > 0, totals_s, np.float32(1.0)).astype(
                        np.float32
                    )
                    frac = np.where(
                        totals_s[None, :] > 0, alloc_s / safe[None, :], np.float32(0.0)
                    )
                    chain_keys.append(frac.max(axis=1))
            order = np.lexsort(tuple([tiebreak_j] + list(reversed(chain_keys))))
        else:
            order = np.arange(0, dtype=np.int64)

        self.jobs = [in_jobs[k] for k in order]
        self.job_rows = [rows_l[k] for k in order]
        jb = bucket(max(j, 1))
        offsets = np.zeros(jb, dtype=np.int32)
        nums = np.zeros(jb, dtype=np.int32)
        deficits = np.zeros(jb, dtype=np.int32)
        gang_order = np.zeros(jb, dtype=np.int32)
        priorities = np.zeros(jb, dtype=np.int32)
        queues_idx = np.zeros(jb, dtype=np.int32)
        alloc_init = np.zeros((jb, r), dtype=np.float64)
        tiebreak = np.full(jb, 2**31 - 1, dtype=np.int32)

        nums[:j] = nums_j[order]
        offsets[:j] = np.concatenate([[0], np.cumsum(nums[: j - 1])]) if j else 0
        gang_order[:j] = gang_j[order]
        deficits[:j] = gang_order[:j] if gang_break else 0
        priorities[:j] = prio_j[order]
        tiebreak[:j] = tiebreak_j[order]
        alloc_init[:j] = alloc_j[order]
        queues_idx[:j] = np.asarray(
            [queue_pos[job.queue] for job in self.jobs], dtype=np.int32
        )
        t_total = int(nums[:j].sum()) if j else 0

        self.flat_count = t_total
        node_src = (
            ssn.nodes
            if getattr(ssn.nodes, "ledger", None) is not None
            else sorted(ssn.nodes.values(), key=lambda nd: nd.name)
        )
        cache_obj = getattr(ssn, "cache", None)
        node_cache = getattr(cache_obj, "node_tensor_cache", None)
        snap_gen = getattr(ssn, "node_generation", -1)
        node_key = (
            (snap_gen, vocab.size, len(ssn.nodes))
            if node_cache is not None and snap_gen >= 0
            else None
        )
        st = build_snapshot_tensors_columnar(
            node_src, self.jobs, list(zip(self.jobs, self.job_rows)), queue_names, vocab,
            node_cache=node_cache, node_key=node_key,
        )
        self.st = st
        self._queues_of_jobs = queues_idx

        self.use_static = bool(ssn.device_predicates or ssn.device_scorers)
        self.node_names = st.nodes.names
        n = st.nodes.count
        nb = bucket(max(n, 1))
        tb = bucket(max(t_total, 1))
        self.n_bucket = nb
        self._t_bucket = tb

        node_gate = pad_rows(st.nodes.ready, nb, fill=False)
        total = st.nodes.allocatable.sum(axis=0)

        # Run lengths: consecutive tasks with identical request rows, counted
        # from each position — the kernel batches a whole run per placement
        # step.  Runs stay within one job, EXCEPT that consecutive
        # single-task jobs merge in cursor mode.
        t_count = t_total
        run_host = np.ones(tb, dtype=np.int32)
        merge_any = False
        if t_count > 1:
            req_m = st.tasks.resreq[:t_count]
            init_m = st.tasks.init_resreq[:t_count]
            jidx = st.tasks.job_idx[:t_count]
            same = np.all(req_m[1:] == req_m[:-1], axis=1) & np.all(
                init_m[1:] == init_m[:-1], axis=1
            )
            jb_change = jidx[1:] != jidx[:-1]
            if single_queue:
                single_job = nums == 1
                both_single = single_job[jidx[1:]] & single_job[jidx[:-1]]
                merge_host = same & (~jb_change | both_single)
            else:
                merge_host = same & ~jb_change
            merge_any = bool(merge_host.any())
            if merge_any:
                # Cohort table summary, and the spill estimate gating the
                # multi-chunk cohort step: a cohort provably spills when its
                # length exceeds even the most optimistic single-node
                # capacity (per resource, the cluster-wide max idle over
                # the request).
                starts = merge_host & ~np.concatenate([[False], merge_host[:-1]])
                self.cohort_count = int(starts.sum())
                self.cohort_tasks = int(merge_host.sum()) + self.cohort_count
                start_idx = np.nonzero(np.concatenate([starts, [False]]))[0]
                bounds = np.nonzero(np.concatenate([[True], ~merge_host, [True]]))[0]
                run_len_of = np.diff(bounds)
                lens = run_len_of[np.searchsorted(bounds[:-1], start_idx)]
                max_idle = (
                    st.nodes.idle.max(axis=0)
                    if st.nodes.count
                    else np.zeros(req_m.shape[1])
                )
                reqs = req_m[start_idx]
                with np.errstate(divide="ignore", invalid="ignore"):
                    cap = np.where(reqs > 0, max_idle[None, :] / reqs, np.inf)
                cap_s = np.floor(cap.min(axis=1))
                if "pod_count" in ssn.device_dynamic_gates:
                    pods_room = int(
                        (st.nodes.pods_limit - st.nodes.task_count).max()
                    ) if st.nodes.count else 0
                    cap_s = np.minimum(cap_s, pods_room)
                self.cohort_spill = bool((np.minimum(lens, MAX_BATCH) > cap_s).any())
                # run[i] = distance to the next break: boundary i sits between
                # tasks i and i+1; a reverse running minimum over break
                # positions gives the first break at-or-after every position.
                idx = np.arange(t_count, dtype=np.int32)
                cand = np.where(merge_host, np.int32(t_count), idx[1:])
                next_brk = np.minimum.accumulate(cand[::-1])[::-1]
                run = np.concatenate([next_brk - idx[: t_count - 1], [1]])
                run_host[:t_count] = np.clip(run, 1, MAX_BATCH)

        self.batch_runs = merge_any
        self.has_releasing = bool(np.any(st.nodes.releasing))
        self.enforce_pod_count = "pod_count" in ssn.device_dynamic_gates

        # --- modes: only the cursor-mode mega arm is ported -------------------
        if not single_queue:
            raise NotImplementedError(
                "fused allocate mode not ported: multi-queue proportion"
            )
        if self.has_releasing:
            raise NotImplementedError(
                "fused allocate mode not ported: releasing capacity"
            )
        if self.use_static:
            raise NotImplementedError(
                "fused allocate mode not ported: static [T,N] rows"
            )
        binpack_only = (
            self.weights[0] == 0.0
            and self.weights[1] == 0.0
            and self.weights[2] > 0.0
        )
        score_bound = self.batch_runs and not binpack_only
        mega_ok = _mk.mega_supported(
            has_releasing=False,
            use_static=False,
            score_bound=score_bound,
            cursor_mode=True,
            r_dim=r,
            n=nb,
            n_sigs=1,  # signature count checked after the table builds
            comparators=self.comparators,
        )
        if not mega_ok:
            raise NotImplementedError(
                "fused allocate mode not ported: XLA while-loop / K1 path "
                "(mega gate closed)"
            )
        self.use_mega = False
        state = {
            "idle": pad_rows(scale_columns(st.nodes.idle, scale), nb),
            "task_count": pad_rows(st.nodes.task_count.astype(np.int32), nb),
            "allocatable": pad_rows(scale_columns(st.nodes.allocatable, scale), nb),
            "pods_limit": pad_rows(st.nodes.pods_limit.astype(np.int32), nb),
        }
        self._prepare_mega(
            policy, scale, state, node_gate, nb, tb, r, offsets, nums, deficits,
            gang_order, priorities, tiebreak, alloc_init, total, run_host,
            score_bound,
        )

    def _prepare_mega(self, policy, scale, state, node_gate, nb, tb, r,
                      offsets, nums, deficits, gang_order, priorities,
                      tiebreak, alloc_init, total, run_host,
                      score_bound) -> None:
        """Stage the mega kernel's operands on the device — per-signature
        request table, lane-packed job columns, transposed node rows — and
        its static arguments.  Sets ``use_mega``."""
        from scheduler_tpu_torch.api.vocab import CPU as _CPU_IDX, MEMORY as _MEM_IDX

        t = self.flat_count
        if t == 0:
            return  # nothing pending: no launch
        req_s = np.asarray(scale_columns(self.st.tasks.resreq[:t], scale), dtype=np.float32)
        init_s = np.asarray(
            scale_columns(self.st.tasks.init_resreq[:t], scale), dtype=np.float32
        )
        inverse, uniq_rows = _mk.request_signature_ids(req_s, init_s)
        s_count = uniq_rows.shape[0]
        if s_count > 4096:
            raise NotImplementedError(
                "fused allocate mode not ported: XLA while-loop / K1 path "
                "(more than 4096 request signatures)"
            )
        s_pad = max(128, -(-s_count // 128) * 128)
        sig_req = np.zeros((16, s_pad), dtype=np.float32)
        sig_req[SIG_REQ.REQ : SIG_REQ.REQ + r, :s_count] = uniq_rows[:, :r].T
        sig_req[SIG_REQ.INIT : SIG_REQ.INIT + r, :s_count] = uniq_rows[:, r:].T
        task_sig = _mk.pack_task_table_i32(inverse.astype(np.int32), tb)

        jb = nums.shape[0]
        j_pad = -(-(jb + _mk.MAX_BATCH) // 128) * 128
        job_off = _mk.pack_lane_i32(offsets.astype(np.int32), j_pad)
        job_num = _mk.pack_lane_i32(nums.astype(np.int32), j_pad)
        job_def = _mk.pack_lane_i32(deficits.astype(np.int32), j_pad)
        job_gang = _mk.pack_lane_i32(gang_order.astype(np.int32), j_pad)
        job_prio = _mk.pack_lane_i32(priorities.astype(np.int32), j_pad)
        job_tb = np.full((1, j_pad), 2**31 - 1, dtype=np.int32)
        job_tb[0, :jb] = tiebreak.astype(np.int32)

        js_drf0 = np.zeros((8, j_pad), dtype=np.float32)
        js_drf0[:r, :jb] = np.asarray(scale_columns(alloc_init, scale), dtype=np.float32).T
        tot_s = np.asarray(scale_columns(total[None, :], scale), dtype=np.float32)[0]
        drf_safe = np.ones((8, 1), dtype=np.float32)
        drf_safe[:r, 0] = np.where(tot_s > 0, tot_s, 1.0)
        drf_mask = np.zeros((8, 1), dtype=np.float32)
        drf_mask[:r, 0] = (tot_s > 0).astype(np.float32)

        misc = np.zeros((1, 8), dtype=np.int32)
        misc[0, 0] = len(self.jobs)  # n_real: every kept job has pending rows

        dev = self.device

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        t_rows = _mk.task_table_rows(tb)
        run2 = np.ones(t_rows * 128, dtype=np.int32)
        run2[:tb] = run_host
        idle = to_dev(state["idle"])
        ns0 = _mk.build_node_ledgers(idle, to_dev(state["task_count"]), nb, r)
        alloc_t = torch.zeros((8, nb), dtype=torch.float32, device=dev)
        alloc_t[:r] = to_dev(state["allocatable"]).T
        # Operands of modes this package does not port: minimum-size dummies.
        zeros8 = np.zeros((8, 128), dtype=np.float32)
        self._mega_args = (
            ns0,
            alloc_t,
            torch.zeros((8, nb), dtype=torch.float32, device=dev),   # rel0
            to_dev(node_gate)[None, :],
            to_dev(state["pods_limit"].astype(np.float32))[None, :],
            to_dev(sig_req),
            to_dev(task_sig),
            to_dev(run2.reshape(t_rows, 128)),
            to_dev(job_off),
            to_dev(job_num),
            to_dev(job_def),
            to_dev(job_gang),
            to_dev(job_prio),
            to_dev(job_tb),
            to_dev(js_drf0),
            to_dev(drf_safe),
            to_dev(drf_mask),
            to_dev(_mk.pack_task_table_i32(np.zeros(0, np.int32), tb)),  # msig
            torch.zeros((8, nb), dtype=torch.float32, device=dev),   # smask
            torch.zeros((8, nb), dtype=torch.float32, device=dev),   # sscore
            to_dev(np.zeros((1, 128), dtype=np.int32)),              # jqueue
            to_dev(zeros8),                                          # jq_des
            to_dev(zeros8),                                          # jq_alloc0
            to_dev(zeros8),                                          # qf_share
            to_dev(zeros8),                                          # qf_over
            to_dev(misc),
        )
        mins_f32 = np.asarray(policy.scaled_mins(r), dtype=np.float32)
        # Cohort chunks engage only where a run can continue past a node's
        # capacity cut: run batching live AND the host spill estimate says
        # some cohort must actually split across nodes.
        cohort_eff = self.cohort_chunks if (self.batch_runs and self.cohort_spill) else 1
        self.cohort_effective = cohort_eff
        self._mega_kw = dict(
            r_dim=r,
            weights=self.weights,
            enforce_pod_count=self.enforce_pod_count,
            comparators=self.comparators,
            cross_batch=self.batch_runs,
            batch_runs=self.batch_runs,
            has_releasing=False,
            use_static=False,
            score_bound=score_bound,
            mins=tuple(float(x) for x in mins_f32),
            cpu_idx=_CPU_IDX,
            mem_idx=_MEM_IDX,
            multi_queue=False,
            queue_proportion=False,
            overused_gate=False,
            queue_delta=True,
            qfair_ladder=False,
            cohort=cohort_eff,
            t_cap=tb,
            mesh=None,
        )
        self.use_mega = True

    # -- capability probe ----------------------------------------------------

    @staticmethod
    def supported(ssn, jobs: Optional[Sequence[JobInfo]] = None) -> bool:
        """True iff every registered callback is in the fused builtin set
        (the JAX engine's gate, unchanged: the port declines the same
        sessions)."""
        if not ssn.nodes:
            return False
        for name in ssn.predicate_fns:
            if name not in ssn.device_predicates:
                return False
        if ssn.device_predicates or ssn.device_scorers:
            n_bucket = bucket(max(len(ssn.nodes), 1))
            sized = ssn.jobs.values() if jobs is None else jobs
            pending = sum(job.pending_eligible_count() for job in sized)
            t_bucket = bucket(max(pending, 1))
            if 5 * t_bucket * n_bucket > 160 * 1024 * 1024:
                return False
        if set(ssn.job_order_fns) - set(_KNOWN_JOB_ORDER):
            return False
        if set(ssn.queue_order_fns) - {"proportion"}:
            return False
        if set(ssn.overused_fns) - {"proportion"}:
            return False
        if (ssn.queue_order_fns or ssn.overused_fns) and (
            "proportion" not in ssn.device_queue_fair
        ):
            return False
        if set(ssn.job_ready_fns) - {"gang"}:
            return False
        if ssn.batch_node_order_fns:
            return False
        scoring = set(ssn.node_order_fns) | set(ssn.node_map_fns)
        if scoring - ssn.device_weighted_plugins:
            return False
        return True

    # -- run + decode --------------------------------------------------------

    def dispatch(self) -> None:
        """Launch the kernel WITHOUT blocking (the launch is enqueued on the
        current stream); ``readback`` collects it.  A no-op when a launch is
        already in flight or nothing is pending."""
        if self._dev is not None or not self.use_mega:
            return
        if self.device.type == "cuda":
            # Kernel time on the device clock, read at readback.
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._dev, self._dev_stats = _mk.mega_allocate(*self._mega_args, **self._mega_kw)
        if self._events is not None:
            self._events[1].record()

    def readback(self) -> np.ndarray:
        """Blocking collect of the dispatched launch's placement codes
        (dispatching first when no launch is in flight)."""
        if not self.use_mega:
            self._encoded = np.zeros(0, dtype=np.int32)
            self._stats_raw = None
            return self._encoded
        if self._dev is None:
            self.dispatch()
        dev, self._dev = self._dev, None
        stats, self._dev_stats = self._dev_stats, None
        self._encoded = dev.cpu().numpy().astype(np.int32, copy=False)
        self._stats_raw = stats.cpu().numpy()
        if self._events is not None:
            start, stop = self._events
            self._events = None
            self.kernel_ms = start.elapsed_time(stop)
        return self._encoded

    def _codes(self) -> np.ndarray:
        encoded = self._encoded
        if encoded is None:
            encoded = self.readback()
        return encoded

    def run_stats(self) -> dict:
        """Cohort/step evidence of the last launch: cohorts seen by the
        build, loop steps, tasks per step, chunk placements."""
        out = {
            "engine": "mega" if self.use_mega else "none",
            "cohorts": self.cohort_count,
            "cohort_chunks": self.cohort_effective,
        }
        enc = self._encoded
        if enc is not None:
            codes = enc[: self.flat_count]
            out["placed"] = int(((codes >= 0) | (codes <= _PIPE_BASE)).sum())
        raw = self._stats_raw
        if raw is not None:
            steps = int(raw[STATS.STEPS])
            out["steps"] = steps
            out["cohort_steps"] = int(raw[STATS.COHORT_STEPS])
            out["chunk_placed"] = int(raw[STATS.CHUNK_PLACED])
            out["fallback_steps"] = steps - out["cohort_steps"]
            if steps > 0 and "placed" in out:
                out["tasks_per_step"] = round(out["placed"] / steps, 2)
        if self.kernel_ms is not None:
            out["kernel_ms"] = self.kernel_ms
        return out

    def run_columnar(self):
        """Execute the kernel (once) and decode WITHOUT task objects.

        Returns ``(items, node_batches, failures)``:
          items        [(job, rows, names, ids, pipe)] — placed job-store rows
                       in placement (task) order, target node name + engine
                       node index per row, and the pipelined mask — the
                       ``Session.bulk_apply_columnar`` contract;
          node_batches node name -> [(cores, status)] deferred node records;
          failures     [(job, row)] first-infeasible rows (FitError sites).
        """
        encoded = self._codes()
        names_arr = np.asarray(self.node_names, dtype=object)

        items = []
        failures = []
        flat_nid = []
        flat_pipe = []
        flat_cores = []
        base = 0
        for job, rows in zip(self.jobs, self.job_rows):
            n = len(rows)
            if n == 0:
                items.append((job, rows[:0], np.empty(0, dtype=object),
                              np.zeros(0, np.int32), np.zeros(0, bool)))
                continue
            codes = encoded[base : base + n]
            base += n
            placed_alloc = codes >= 0
            placed_pipe = codes <= _PIPE_BASE
            placed = placed_alloc | placed_pipe
            fail = np.nonzero(codes == FAILED)[0]
            if fail.shape[0]:
                failures.append((job, int(rows[fail[0]])))
            sel_rows = rows[placed]
            if sel_rows.shape[0] == 0:
                items.append((job, sel_rows, np.empty(0, dtype=object),
                              np.zeros(0, np.int32), np.zeros(0, bool)))
                continue
            nid = np.where(codes >= 0, codes, _PIPE_BASE - codes)[placed]
            pipe = placed_pipe[placed]
            items.append((job, sel_rows, names_arr[nid], nid.astype(np.int32), pipe))
            flat_cores.append(job.store.cores[sel_rows])
            flat_nid.append(nid)
            flat_pipe.append(pipe)

        node_batches: Dict[str, list] = {}
        if flat_cores:
            cores_all = np.concatenate(flat_cores)
            nid_all = np.concatenate(flat_nid)
            pipe_all = np.concatenate(flat_pipe)
            # Group into per-(node, status) batches with one stable sort and
            # pure array gathers — no per-task Python.
            key = nid_all * 2 + pipe_all
            order = np.argsort(key, kind="stable")
            cores_sorted = cores_all[order]
            uniq, starts = np.unique(key[order], return_index=True)
            bounds = starts.tolist() + [order.shape[0]]
            for g, k in enumerate(uniq.tolist()):
                node_name = self.node_names[k >> 1]
                status = TaskStatus.PIPELINED if (k & 1) else TaskStatus.ALLOCATED
                members = cores_sorted[bounds[g] : bounds[g + 1]]
                node_batches.setdefault(node_name, []).append((members, status))
        return items, node_batches, failures

    def commit_plan(self):
        """Array-level ledger aggregates of the last run (CommitPlan) — lets
        bulk_apply skip per-task ResourceVec arithmetic entirely."""
        from scheduler_tpu_torch import native
        from scheduler_tpu_torch.api.commit_plan import CommitPlan

        t = self.flat_count
        node_id, pipelined, _failed, _n = native.decode_placement_codes(
            self._codes()[:t]
        )
        job_ids = self.st.tasks.job_idx[:t]
        queue_ids = self._queues_of_jobs[np.clip(job_ids, 0, None)].astype(np.int32)
        queue_ids = np.where(job_ids >= 0, queue_ids, -1).astype(np.int32)
        return CommitPlan(
            matrix=self.st.tasks.resreq[:t],
            node_id=node_id,
            pipelined=pipelined,
            job_ids=job_ids,
            queue_ids=queue_ids,
            node_names=self.node_names,
            job_uids=[j.uid for j in self.jobs],
            queue_uids=self.queue_uids,
        )
