"""DeviceAllocator: binds a Session to the per-pop placement engine, and
the session -> engine helpers the fused allocator shares with it.

The per-pop engine (``DeviceAllocator``) builds the session's snapshot
tensors once per action execution, on the session's device, then serves
per-job placement calls (one launch of the scan kernel a pop,
``ops/placement.py``) that thread the node state (idle, releasing, task
counts) from job to job in place: the host never re-uploads node state
inside an action.  The allocate action takes it where the fused engine's
gate declines (the static ``[T, N]`` rows past its memory limit) and every
plugin is device-capable, as the JAX package does.

Plugins contribute to the static tensors through two session registries:

* ``ssn.device_predicates[name](st, device) -> bool [T, N]`` mask
  contributions (or None: no constraint this session);
* ``ssn.device_scorers[name](st, device) -> f32 [T, N]`` score
  contributions (or None);

and ``ssn.device_score_weights`` weighs the idle-dependent dynamic scorers.
``DeviceAllocator.supported()`` refuses sessions where some plugin
registered a host predicate or node-order callback without a device
counterpart: those take the host loop.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.tensors import bucket, build_snapshot_tensors_columnar
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.ops.device import DevicePolicy, pad_rows, resolve_device, scale_columns
from scheduler_tpu_torch.ops.placement import (
    JobPlacementSpec,
    NodeState,
    PlacementResult,
    sequential_place_job,
)
from scheduler_tpu_torch.ops.predicates import base_static_mask
from scheduler_tpu_torch.ops.transfer_cache import to_device
from scheduler_tpu_torch.utils.scheduler_helper import task_sort_key


def gang_ready_active(ssn) -> bool:
    """True iff gang's job_ready veto is actually consulted: registered AND
    enabled in some tier.  When it isn't, ``ssn.job_ready`` is vacuously true
    and the allocate ready-break fires after every placement (deficit 0), so
    pops place one task then re-select — the device engine must mirror that."""
    if "gang" not in ssn.job_ready_fns:
        return False
    return any(
        p.name == "gang" and p.job_ready_enabled()
        for tier in ssn.tiers
        for p in tier.plugins
    )


def collect_pending(job: JobInfo, sort_key) -> List[TaskInfo]:
    """A job's pending, non-best-effort tasks in task order (allocate.go:119-133)."""
    pending = [
        t
        for t in job.task_status_index.get(TaskStatus.PENDING, {}).values()
        if not t.resreq_empty
    ]
    pending.sort(key=sort_key)
    return pending


def score_weights(ssn) -> Tuple[float, float, float]:
    """(least_requested, balanced, binpack) weights for the dynamic scorers."""
    w = ssn.device_score_weights
    return (
        float(w.get("least_requested", 0.0)),
        float(w.get("balanced", 0.0)),
        float(w.get("binpack", 0.0)),
    )


def build_static_tensors(ssn, st, n_bucket: int, device, t_rows: Optional[int] = None):
    """Session-static tensors on ``device``: ``(bool [t_rows, n_bucket] mask,
    f32 [t_rows, n_bucket] score or None)`` — the node-ready gate AND every
    registered device predicate, and the summed static scorer contributions,
    each built in place at its final width (``t_rows`` default: one row a
    task; pad task rows and pad nodes are infeasible).  The score is None
    where no scorer contributes: the per-pop scan then adds 0, which is what
    the JAX package's all-zero rows give, without the [T, N] zeros."""
    t_count = max(st.tasks.count, 1)
    t_rows = t_count if t_rows is None else t_rows
    n = st.nodes.count
    mask_p = torch.zeros((t_rows, n_bucket), dtype=torch.bool, device=device)
    mask = mask_p[:t_count, :n]
    mask.copy_(base_static_mask(t_count, to_device(st.nodes.ready, device=device)))
    for builder in ssn.device_predicates.values():
        contribution = builder(st, device)
        if contribution is None:
            continue  # builder declared "no constraint this session"
        mask &= torch.as_tensor(contribution, dtype=torch.bool, device=device)
    score_p = None
    for builder in ssn.device_scorers.values():
        contribution = builder(st, device)
        if contribution is None:
            continue
        if score_p is None:
            score_p = torch.zeros((t_rows, n_bucket), dtype=torch.float32, device=device)
        score_p[:t_count, :n] += torch.as_tensor(contribution, dtype=torch.float32,
                                                 device=device)
    if score_p is not None:
        # Clamp to finite values ONCE here: the engines' any-feasible check
        # reads the winner's masked score against -inf, so a feasible node
        # whose scorer emitted -inf/NaN must not be mistaken for masked-out.
        score_p[:t_count, :n].nan_to_num_(nan=0.0, posinf=1e30, neginf=-1e30)
    return mask_p, score_p


def build_static_tensors_device(ssn, st, n_bucket: int, t_bucket: int, device):
    """The fused engine's session-static ``(bool [t_bucket, n_bucket] mask,
    f32 [t_bucket, n_bucket] score)``: ``build_static_tensors`` at
    ``t_bucket`` rows, the score zero where no scorer contributes."""
    mask, score = build_static_tensors(ssn, st, n_bucket, device, t_rows=t_bucket)
    if score is None:
        score = torch.zeros((t_bucket, n_bucket), dtype=torch.float32, device=device)
    return mask, score


def node_state_from_tensors(st, policy: DevicePolicy, n_bucket: int, device) -> NodeState:
    """Padded, unit-scaled NodeState on ``device`` from host snapshot
    tensors.  The uploads go through the transfer cache (its residents may
    be shared): the caller copies what it writes."""
    r = policy.vocab.size
    scale = policy.column_scale(r)

    def prep(mat: np.ndarray) -> torch.Tensor:
        return to_device(pad_rows(scale_columns(mat, scale), n_bucket), np.float32, device)

    return NodeState(
        idle=prep(st.nodes.idle),
        releasing=prep(st.nodes.releasing),
        task_count=to_device(pad_rows(st.nodes.task_count.astype(np.int32), n_bucket),
                             device=device),
        allocatable=prep(st.nodes.allocatable),
        # pad nodes get pods_limit 0 -> never feasible under the pod-count gate
        pods_limit=to_device(pad_rows(st.nodes.pods_limit.astype(np.int32), n_bucket),
                             device=device),
        mins=to_device(policy.scaled_mins(r), np.float32, device),
    )


class DeviceAllocator:
    """The per-pop engine (``scheduler_tpu/ops/allocator.py:181-313``):
    built once per allocate execution over the static jobs, then one scan
    a job pop (``place_job``).  ``run_stats()`` counts pops, tasks scanned
    and, on CUDA, the scan kernel's summed event time."""

    def __init__(self, ssn, jobs: Sequence[JobInfo], device=None) -> None:
        self.ssn = ssn
        self.device = resolve_device(getattr(ssn, "device", None) if device is None else device)
        vocab = next(iter(ssn.nodes.values())).vocab if ssn.nodes else None
        if vocab is None:
            raise ValueError("cannot build a device allocator without nodes")
        self.policy = DevicePolicy(vocab)

        # Pending, non-best-effort tasks of every candidate job, in task order.
        sort_key = task_sort_key(ssn)
        self.tasks: List[TaskInfo] = []
        per_job = []
        for job in jobs:
            pending = collect_pending(job, sort_key)
            self.tasks.extend(pending)
            row_of = job.store.row_of
            per_job.append((job, np.asarray([row_of[t.uid] for t in pending], dtype=np.int64)))

        node_src = (
            ssn.nodes
            if getattr(ssn.nodes, "ledger", None) is not None
            else sorted(ssn.nodes.values(), key=lambda nd: nd.name)
        )
        self.st = build_snapshot_tensors_columnar(node_src, list(jobs), per_job,
                                                  sorted(ssn.queues), vocab)
        n = self.st.nodes.count
        r = vocab.size
        self.n_nodes = n
        self.n_bucket = bucket(max(n, 1))
        scale = self.policy.column_scale(r)
        self.node_names = self.st.nodes.names
        self._row = self.st.tasks.index

        # The scan writes idle, releasing and task counts in place, and the
        # transfer cache's residents may be shared: the engine owns copies.
        state = node_state_from_tensors(self.st, self.policy, self.n_bucket, self.device)
        state.idle = state.idle.clone()
        state.releasing = state.releasing.clone()
        state.task_count = state.task_count.clone()
        self.state = state

        # Static [T, N] predicate mask + score, built on the device
        # (selector/taint enforcement lives in the predicates plugin).
        self.static_mask, self.static_score = build_static_tensors(
            ssn, self.st, self.n_bucket, self.device
        )
        self.weights: Tuple[float, float, float] = score_weights(ssn)
        self.enforce_pod_count = "pod_count" in ssn.device_dynamic_gates

        t = self.st.tasks.count
        if t:
            init = scale_columns(self.st.tasks.init_resreq, scale)
            req = scale_columns(self.st.tasks.resreq, scale)
        else:
            init = req = np.zeros((1, r), np.float32)
        self._init_resreq = torch.from_numpy(np.ascontiguousarray(init)).to(self.device)
        self._resreq = torch.from_numpy(np.ascontiguousarray(req)).to(self.device)
        self.stats = {"pops": 0, "tasks_scanned": 0}
        self.kernel_ms = 0.0 if self.device.type == "cuda" else None
        self.wrapper_ms = 0.0  # host time in the scan's wrapper (CUDA only)
        self._events = None

    # -- capability probe ----------------------------------------------------

    @staticmethod
    def supported(ssn) -> bool:
        """Every host predicate/node-order callback has a device counterpart."""
        for name in ssn.predicate_fns:
            if name not in ssn.device_predicates:
                return False
        if ssn.batch_node_order_fns:
            # Batch priorities (InterPodAffinity) score against live
            # placements across the whole node set — host path only.
            return False
        scoring_fns = set(ssn.node_order_fns) | set(ssn.node_map_fns)
        for name in scoring_fns:
            if name not in ssn.device_scorers and name not in ssn.device_weighted_plugins:
                return False
        return bool(ssn.nodes)

    # -- placement -----------------------------------------------------------

    def ready_deficit(self, job: JobInfo) -> Optional[int]:
        """Allocations still needed before the JobReady break fires.

        gang registered: min_available - ready_task_num (<= 0 means the job
        is already ready, so the first placement of any kind stops the pop);
        no job_ready fns: JobReady is vacuously true -> deficit 0.  Any other
        job_ready plugin -> unknown semantics, caller must fall back.
        """
        fns = set(self.ssn.job_ready_fns)
        if not fns:
            return 0
        if fns == {"gang"}:
            if not gang_ready_active(self.ssn):
                # Registered but disabled by the conf enable flag: the veto-AND
                # dispatch skips it, JobReady is vacuously true -> deficit 0.
                return 0
            return job.min_available - job.ready_task_num()
        return None

    def place_job(self, job: JobInfo, tasks: List[TaskInfo]
                  ) -> Optional[List[Tuple[TaskInfo, Optional[str], bool, bool]]]:
        """Run the placement scan for one job pop.

        Returns [(task, node_name | None, pipelined, failed)] rows in task
        order, covering only the prefix the scan actually processed (up to
        the ready break / first failure), or None if this job needs the host
        fallback.
        """
        deficit = self.ready_deficit(job)
        if deficit is None or not tasks:
            return None
        if deficit <= 0:
            # The gang is already ready: the ready break fires on the first
            # placement (or first failure), so scan one task.
            tasks = tasks[:1]

        rows = torch.as_tensor(np.asarray([self._row[t.uid] for t in tasks], dtype=np.int32),
                               device=self.device)
        spec = JobPlacementSpec(
            init_resreq=self._init_resreq, resreq=self._resreq,
            static_mask=self.static_mask, static_score=self.static_score, rows=rows,
            ready_deficit=deficit, n_active=self.n_nodes,
        )
        events = None
        if self.kernel_ms is not None:
            if self._events is None:  # one pair, read after each pop's readback
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
            events = self._events
        self.state, result = sequential_place_job(
            self.state, spec, self.weights, enforce_pod_count=self.enforce_pod_count,
            events=events,
        )
        if events is not None:
            self.kernel_ms += events[0].elapsed_time(events[1])  # the readback synchronized
            self.wrapper_ms += 1e3 * result.wrapper_s
        self.stats["pops"] += 1
        self.stats["tasks_scanned"] += len(tasks)

        out: List[Tuple[TaskInfo, Optional[str], bool, bool]] = []
        for i, task in enumerate(tasks):
            chosen = int(result.chosen[i])
            if bool(result.failed[i]):
                out.append((task, None, False, True))
                break
            if chosen < 0:
                break  # scan stopped before this task (ready break fired)
            out.append((task, self.node_names[chosen], bool(result.pipelined[i]), False))
        return out

    def run_stats(self) -> dict:
        """The engine's evidence: pops, tasks scanned and (CUDA only) the
        scan kernel's summed event ms and the host ms spent in its
        wrapper."""
        out = dict(self.stats, engine="device")
        if self.kernel_ms is not None:
            out["kernel_ms"] = self.kernel_ms
            out["wrapper_ms"] = self.wrapper_ms
        return out
