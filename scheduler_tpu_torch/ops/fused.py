"""Fused allocate: the ENTIRE allocate action on the device, one result array.

Host shim of the two device engines: session -> snapshot tensors -> job and
task ordering -> the engine's staged operands -> the run -> decoded rows for
the commit.  It mirrors the JAX package's ``FusedAllocator``
(``scheduler_tpu/ops/fused.py``), with run batching of identical requests,
in its two job-selection modes: CURSOR MODE (one queue and no queue chain,
jobs laid out in init-key order) and MULTI-QUEUE MODE (several queues, or
any session whose conf names proportion: the queue pop by proportion's live
share and overused gate, then the job chain within the winning queue, with
the deserved and allocated rows of proportion's water-fill).  Its engines:

* **mega** — the whole loop as ONE launch of the mega kernel
  (``ops/megakernel.py``), in either selection mode, with cohort chunks
  and, when the predicates or nodeorder plugin contributes session-static
  mask/score rows, the kernel's static-row mode (one mask and score row per
  static signature), and, where evicted pods still hold RELEASING
  capacity, the kernel's releasing mode (a task fits on idle or releasing;
  on releasing alone it is pipelined);
* **step** and **xla** — where the mega gate closes (more than 4,096
  request signatures, a node bucket past 32,768, static rows past 4 MiB):
  ``fused_allocate``, the JAX engine's while loop, driven from the host in
  every selection mode (the cursor; the queue pop of multi-queue and
  unsorted sessions with its delta, full-recompute and ladder chains).  A
  step's selection is ONE launch of the placement-step kernel
  (``ops/step_kernel.py``, engine ``step``) where the JAX step-kernel gate
  admits the session, or else the loop's XLA step arm (``ops/xla_step.py``,
  engine ``xla``: one launch of ``csrc/xla_step.cu`` a step with the node
  state resident on the device), which the JAX engine takes where the top-2 score bound
  is live (runs batch under scorers other than binpack alone), where the
  node bucket is past 65,536, and for releasing capacity (the joint
  idle / releasing fit, pipelined codes).  The loop reads static rows by
  static signature ([S, N]), never a [T, N] buffer.

The engine is chosen by the JAX engine's gates before anything runs, and
nothing falls back: a kernel that fails raises.  ``chip_smoke.py`` runs
the loop's arms at full size on paths c (K1), i (the XLA arm under the
default conf's tiers), j (K1 with the multi-queue pop) and k (the
releasing arm); ``tests/test_torch_loop_arms.py`` holds them to the JAX
loop on the CPU.  A multi-queue session keeps its queue shares by the
delta chain, by the full-recompute chain
(``SCHEDULER_TORCH_QUEUE_DELTA=0``) or, where the JAX engine admits it, by
the qfair class ladder (``ops/qfair.py``; ``SCHEDULER_TORCH_QFAIR=host``
turns off both the ladder and proportion's device water-fill).

The LP flavor (``SCHEDULER_TORCH_ALLOCATOR=lp``, ``ops/lp_place.py``) takes
the place of the greedy engines where its gate admits the session: the
relaxation (``csrc/lp_relax.cu`` on the card) over the whole rows x nodes
tensor, on signature classes where tasks repeat (``ops/sig_compress.py``),
then the repair, the loop above on its XLA step arm with the marginals as
the static score, the open-state feasibility as the static mask and zero
dynamic weights.

The node mesh (``SCHEDULER_TORCH_MESH`` / ``--mesh``, ``ops/mesh.py``)
splits the node axis over a device list, driven by one controller: the
mega kernel runs once in mesh mode with every operand whole on the mesh's
first device; the loop runs K1 on every shard (``_K1MeshArm``) or the XLA
arm's shard mode (``ops/xla_step.py::XlaShardStep``), the winner merged on
the host; the LP relaxation runs over node blocks.  Every arm gives the
one-device codes.

The result is ONE int32[T] array encoding the whole action:
  >= 0: allocated on that node   |   -1: never reached (left pending)
  -2: first infeasible task of its job (host records FitErrors)
  <= -3: pipelined onto node -3 - code (releasing capacity)
"""

from __future__ import annotations

import heapq
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scheduler_tpu_torch.api.job_info import JobInfo
from scheduler_tpu_torch.api.tensors import bucket, build_snapshot_tensors_columnar
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.ops import megakernel as _mk
from scheduler_tpu_torch.ops.allocator import (
    build_static_tensors_device,
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
from scheduler_tpu_torch.ops import step_kernel as _sk
from scheduler_tpu_torch.ops.transfer_cache import to_device as _to_device
from scheduler_tpu_torch.ops.layout import JOB_STATE, SIG_REQ, STATS
from scheduler_tpu_torch.utils import phases
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

# `cur` sentinel: no selectable job is left, the action is over.
HALT = -100

# Upper bound on placements per micro-step in the run-batched fast path.
MAX_BATCH = 128

_BIG_I32 = 2**31 - 1

# Operands of ``fused_allocate``: the JAX loop's, in its order
# (scheduler_tpu/ops/fused.py:175-221).
FUSED_OPERAND_NAMES = (
    "idle", "releasing", "task_count", "allocatable", "pods_limit", "node_gate",
    "mins", "init_resreq", "resreq", "static_mask", "static_score",
    "job_task_offset", "job_task_num", "job_deficit", "job_gang_order",
    "job_priority", "job_tiebreak", "job_queue", "job_alloc_init", "queue_rank",
    "queue_has_jobs", "queue_deserved", "queue_alloc_init", "drf_total", "run_len",
    "sig_of_task", "qfair_share", "qfair_over",
)

# The loop operands that only the host reads: numpy arrays in ``args``.  The
# rest lie on the engine's device, where the arm of each step reads them (the
# node state starts from the host's ``idle``, ``releasing`` and
# ``task_count`` and stays on the device for the XLA arm).
HOST_OPERANDS = frozenset((
    "idle", "releasing", "task_count", "job_task_offset", "job_task_num", "job_deficit",
    "job_gang_order", "job_priority", "job_tiebreak", "job_queue", "job_alloc_init",
    "queue_rank", "queue_has_jobs", "queue_deserved", "queue_alloc_init", "drf_total",
    "run_len", "sig_of_task", "qfair_share", "qfair_over",
))

# Comparators the fused job-selection chain understands, keyed by plugin name.
_KNOWN_JOB_ORDER = ("priority", "gang", "drf")


def _queue_delta_enabled() -> bool:
    """``SCHEDULER_TORCH_QUEUE_DELTA`` (default on): the delta-maintained
    multi-queue chain; ``0`` re-derives every queue's share at each pop (the
    full-recompute chain, the same results), in the mega kernel and in the
    loop, and declines the qfair ladder."""
    from scheduler_tpu_torch.utils.envflags import env_bool

    return env_bool("SCHEDULER_TORCH_QUEUE_DELTA", True)


def _dirty_delta_enabled() -> bool:
    """``SCHEDULER_TORCH_DIRTY_DELTA`` (default on): the engine cache's hit
    path refreshes only the node rows the cache marked dirty; ``0`` diffs
    the whole node tensors instead.  Both are exact (every marked row is
    still compared by value), so this is an A/B lever and the test's way to
    pin the full-diff path."""
    from scheduler_tpu_torch.utils.envflags import env_bool

    return env_bool("SCHEDULER_TORCH_DIRTY_DELTA", True)


def fused_static_limit() -> int:
    """``SCHEDULER_TORCH_FUSED_STATIC_LIMIT``: the bytes of static [T, N]
    rows (5 an element) up to which the fused engine takes a session
    (default 160 MiB, the JAX package's ``SCHEDULER_TPU_FUSED_STATIC_LIMIT``)."""
    from scheduler_tpu_torch.utils.envflags import env_int

    return env_int("SCHEDULER_TORCH_FUSED_STATIC_LIMIT", 160 * 1024 * 1024, minimum=0)


def _session_device(ssn) -> torch.device:
    """The device a session's engines run on (``None``: CUDA)."""
    dev = getattr(ssn, "device", None)
    return torch.device("cuda" if dev is None else dev)


# The dynamic node tensors a cache hit refreshes.
_DYNAMIC = ("idle", "releasing", "task_count")


def _cohort_chunks(device: torch.device) -> int:
    """Placement chunks per cohort step: 4 on a CUDA device, 1 elsewhere.
    Codes are identical for every count."""
    return 4 if device.type == "cuda" else 1


# -- the loop engine ---------------------------------------------------------------

def stage_step_operands(idle, task_count, allocatable, pods_limit, node_gate, mins,
                        init_resreq, resreq, static_mask, static_score, sig_of_task, *,
                        use_static):
    """The placement-step kernel's operands for a whole loop, as the JAX loop
    stages them (``scheduler_tpu/ops/fused.py:323-351``, ``:982-988``):
    ``(ns_host, alloc, smask, sscore, gate, plim, task_initq, task_req,
    mins, r8, k1_row)``.  ``ns_host`` is the host's float32 [r8 + 8, n]
    node state (idle rows, task-count row r8), built from the host's
    ``idle`` and ``task_count``; ``task_initq`` / ``task_req`` hold the
    request rows (pad rows -1 / 0) that the kernel reads at a step's row
    index; the rest lie on ``allocatable``'s device.

    The kernel reads a task's request rows and its static rows at one row
    index.  Without ``use_static`` that is the task row (``k1_row`` None)
    and the static rows are [1, n] dummies the kernel never reads.  With it
    the static rows come [S, n] with ``sig_of_task`` naming each task's row,
    and the kernel's rows are the distinct (request rows, static row) pairs
    of the tasks: ``k1_row`` [T] maps a task to its pair, and
    ``task_initq`` / ``task_req`` / ``smask`` / ``sscore`` hold one row a
    pair."""
    dev = allocatable.device
    n, r_dim = allocatable.shape
    t_cap = resreq.shape[0]
    r8 = -(-r_dim // 8) * 8
    f32 = torch.float32
    ns_host = np.zeros((r8 + 8, n), dtype=np.float32)
    ns_host[:r_dim] = np.asarray(idle, dtype=np.float32).T
    ns_host[r8] = np.asarray(task_count, dtype=np.float32)
    alloc = torch.zeros((r8, n), dtype=f32, device=dev)
    alloc[:r_dim] = allocatable.T
    task_initq = torch.cat(
        [init_resreq, torch.full((t_cap, r8 - r_dim), -1.0, dtype=f32, device=dev)], dim=1
    ).contiguous()
    task_req = torch.cat(
        [resreq, torch.zeros((t_cap, r8 - r_dim), dtype=f32, device=dev)], dim=1
    ).contiguous()
    mins_c = torch.cat([mins, torch.zeros(r8 - r_dim, dtype=f32, device=dev)])[:, None]
    k1_row = None
    if use_static:
        s_of_t = np.asarray(sig_of_task, dtype=np.int64)[:t_cap]
        if s_of_t.shape[0] != t_cap or static_mask.shape[1] != n:
            raise ValueError(f"static rows: expected [S, {n}] rows and {t_cap} row ids, got "
                             f"{tuple(static_mask.shape)} and {s_of_t.shape[0]}")
        key = np.concatenate([task_initq.cpu().numpy().view(np.int32),
                              task_req.cpu().numpy().view(np.int32),
                              s_of_t[:, None].astype(np.int32)], axis=1)
        _, first, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
        k1_row = inverse.reshape(-1)
        rows = torch.as_tensor(first, device=dev)
        sig_rows = torch.as_tensor(s_of_t[first], device=dev)
        task_initq = task_initq[rows].contiguous()
        task_req = task_req[rows].contiguous()
        smask = static_mask[sig_rows].contiguous()
        sscore = static_score[sig_rows].contiguous()
    else:
        smask = torch.ones((1, n), dtype=torch.bool, device=dev)
        sscore = torch.zeros((1, n), dtype=f32, device=dev)
    gate = node_gate[None, :].contiguous()
    plim = pods_limit.to(f32)[None, :].contiguous()
    return (ns_host, alloc, smask, sscore, gate, plim, task_initq, task_req, mins_c, r8,
            k1_row)


class _K1Arm:
    """The loop's selection as the placement-step kernel (``StepLoop``): the
    same ``step(t_idx, s_idx, hi0)`` as ``ops/xla_step.py::XlaStep``.  The
    host keeps the float32 node-state mirror, sizes the batch from the
    kernel's capacity count and pod room, adds the winner's column and
    pushes it to the kernel with the next step."""

    def __init__(self, staged, req8, *, device, plain, check_every, r_dim, weights,
                 use_static, enforce_pod_count, batch_runs, cpu_idx, mem_idx):
        (ns_host, alloc_t, smask, sscore, gate, plim, task_initq, task_req, mins_c, r8,
         self.k1_row) = staged
        self.loop = _sk.StepLoop(
            ns_host, alloc_t, smask, sscore, gate, plim, task_initq, task_req, mins_c,
            device=device, plain=plain, check_every=check_every, r_dim=r_dim, r8=r8,
            weights=weights, use_static=use_static, enforce_pod_count=enforce_pod_count,
            cpu_idx=cpu_idx, mem_idx=mem_idx, with_capacity=batch_runs)
        self.ns = self.loop.ns_host  # the mirror the stepper pushes columns from
        self.neg_req8 = -req8  # the column add's -req rows, pad rows -0
        self.r8, self.n = r8, ns_host.shape[1]
        self.batch_runs, self.enforce_pod_count = batch_runs, enforce_pod_count
        self.push = -1

    def step(self, t_idx: int, s_idx: int, hi0: int):
        del s_idx  # the kernel's row carries the static row (k1_row)
        row = t_idx if self.k1_row is None else int(self.k1_row[t_idx])
        best, score, cap, pods = self.loop.step(row, self.push)
        self.push = -1
        best = min(best, self.n - 1)
        if score == float("-inf"):
            return best, False, False, False, 1
        if self.batch_runs:
            if self.enforce_pod_count:
                hi0 = min(hi0, pods)
            m = max(min(cap, max(hi0, 1)), 1)
        else:
            m = 1
        m_f = np.float32(m)
        # The node ledger's column add: idle rows -= m * req, task count += m.
        self.ns[:self.r8, best] += self.neg_req8[t_idx] * m_f
        self.ns[self.r8, best] += m_f
        self.push = best
        return best, True, True, False, m

    @property
    def k1_ms(self):
        return self.loop.k1_ms

    @property
    def checked(self) -> int:
        return self.loop.checked

    def close(self) -> None:
        self.loop.close()


class _K1MeshArm:
    """The loop's selection as K1 on every block of a node mesh: the JAX
    loop's per-shard arm (``scheduler_tpu/ops/fused.py:355-450``), one
    ``StepLoop`` a shard over its ``n / D`` node columns.  Each step
    launches K1 on every shard (on CUDA the D launches queue back to back
    before the first wait); the host merges the D ``(score, best +
    offset, cap, pods)`` candidates by the two-level rule
    (``sharded.two_level_winner_with_capacity``: the largest score, the
    lowest shard on ties, so the lowest global index), sizes the batch from
    the winner's capacity and pod room, adds the winner's column to the
    owning shard's float32 mirror only and pushes it to that shard's kernel
    with the next step.  The job's queue id needs no lane: the host picked
    the job."""

    def __init__(self, mesh, idle, task_count, allocatable, pods_limit, node_gate, mins,
                 init_resreq, resreq, static_mask, static_score, sig_of_task, req_h, *,
                 plain, check_every, r_dim, weights, use_static, enforce_pod_count,
                 batch_runs, cpu_idx, mem_idx):
        self.mesh = mesh
        d = mesh.size
        n = allocatable.shape[0]
        self.n, self.n_local = n, n // d
        self.loops, self.mirrors = [], []
        self.k1_row = None
        for k, dev in enumerate(mesh.devices):
            lo, hi = k * self.n_local, (k + 1) * self.n_local
            staged = stage_step_operands(
                np.asarray(idle)[lo:hi], np.asarray(task_count)[lo:hi],
                allocatable.shards[k], pods_limit.shards[k], node_gate.shards[k],
                mins.to(dev), init_resreq.to(dev), resreq.to(dev),
                static_mask.shards[k] if use_static else static_mask.to(dev),
                static_score.shards[k] if use_static else static_score.to(dev),
                sig_of_task, use_static=use_static)
            (ns_host, alloc_t, smask, sscore, gate, plim, task_initq, task_req, mins_c, r8,
             self.k1_row) = staged
            loop = _sk.StepLoop(
                ns_host, alloc_t, smask, sscore, gate, plim, task_initq, task_req, mins_c,
                device=dev, plain=plain, check_every=check_every, r_dim=r_dim, r8=r8,
                weights=weights, use_static=use_static, enforce_pod_count=enforce_pod_count,
                cpu_idx=cpu_idx, mem_idx=mem_idx, with_capacity=batch_runs)
            self.loops.append(loop)
            self.mirrors.append(loop.ns_host)
        self.r8 = r8
        self.neg_req8 = -np.concatenate(
            [req_h, np.zeros((req_h.shape[0], r8 - r_dim), np.float32)], axis=1)
        self.batch_runs, self.enforce_pod_count = batch_runs, enforce_pod_count
        self.push = None  # (shard, local column)

    def step(self, t_idx: int, s_idx: int, hi0: int):
        from scheduler_tpu_torch.ops.sharded import two_level_winner_with_capacity

        del s_idx  # the kernel's row carries the static row (k1_row)
        row = t_idx if self.k1_row is None else int(self.k1_row[t_idx])
        pushes = [self.push[1] if self.push is not None and self.push[0] == k else -1
                  for k in range(len(self.loops))]
        if self.loops[0].cuda:
            # Every shard's launch queued, then one wait a shard.
            for loop, push in zip(self.loops, pushes):
                loop.launch(row, push)
            results = [loop.finish() for loop in self.loops]
        else:
            results = [loop.step(row, push) for loop, push in zip(self.loops, pushes)]
        cands = [(score, min(lbest, self.n_local - 1) + k * self.n_local, cap, pods)
                 for k, (lbest, score, cap, pods) in enumerate(results)]
        self.push = None
        score, best, cap, pods = two_level_winner_with_capacity(cands)
        best = min(best, self.n - 1)
        if score == float("-inf"):
            return best, False, False, False, 1
        if self.batch_runs:
            if self.enforce_pod_count:
                hi0 = min(hi0, pods)
            m = max(min(cap, max(hi0, 1)), 1)
        else:
            m = 1
        m_f = np.float32(m)
        k, col = divmod(best, self.n_local)
        ns = self.mirrors[k]
        ns[:self.r8, col] += self.neg_req8[t_idx] * m_f
        ns[self.r8, col] += m_f
        self.push = (k, col)
        return best, True, True, False, m

    @property
    def k1_ms(self):
        times = [loop.k1_ms for loop in self.loops]
        return None if any(t is None for t in times) else float(sum(times))

    @property
    def checked(self) -> int:
        return sum(loop.checked for loop in self.loops)

    def close(self) -> None:
        for loop in self.loops:
            loop.close()


def _share_overused(deserved, allocated, mins, r_dim):
    """``megakernel.queue_share_overused`` on float32 numpy rows indexed by
    dim first ([r_dim, Q] or one queue's [r_dim]), on the CPU: ``(share
    f32, overused bool)`` as numpy."""
    share, over = _mk.queue_share_overused(
        torch.from_numpy(np.ascontiguousarray(deserved, dtype=np.float32)),
        torch.from_numpy(np.ascontiguousarray(allocated, dtype=np.float32)),
        torch.from_numpy(np.ascontiguousarray(mins, dtype=np.float32)), r_dim)
    return share.numpy(), over.numpy()


def fused_allocate(
    idle: np.ndarray,               # f32 [N, R] (device units, node-bucket padded)
    releasing: np.ndarray,          # f32 [N, R]
    task_count: np.ndarray,         # i32 [N]
    allocatable: torch.Tensor,      # f32 [N, R]
    pods_limit: torch.Tensor,       # i32 [N]
    node_gate: torch.Tensor,        # bool [N] ready & not padding
    mins: torch.Tensor,             # f32 [R]
    init_resreq: torch.Tensor,      # f32 [T, R] (task-bucket padded)
    resreq: torch.Tensor,           # f32 [T, R]
    static_mask: torch.Tensor,      # bool [S, N] ([1, 1] dummy without use_static)
    static_score: torch.Tensor,     # f32 [S, N]
    job_task_offset: np.ndarray,    # i32 [J]
    job_task_num: np.ndarray,       # i32 [J] (0 for padding)
    job_deficit: np.ndarray,        # i32 [J] ready-break deficit
    job_gang_order: np.ndarray,     # i32 [J] gang deficit for the ORDER comparator
    job_priority: np.ndarray,       # i32 [J]
    job_tiebreak: np.ndarray,       # i32 [J] rank by (creation, uid)
    job_queue: np.ndarray,          # i32 [J]
    job_alloc_init: np.ndarray,     # f32 [J, R] drf allocated at session open
    queue_rank: np.ndarray,         # i32 [Q] creation/uid rank
    queue_has_jobs: np.ndarray,     # bool [Q] real queue
    queue_deserved: np.ndarray,     # f32 [Q, R] proportion's deserved share
    queue_alloc_init: np.ndarray,   # f32 [Q, R] queue allocated at session open
    drf_total: np.ndarray,          # f32 [R] cluster totals
    run_len: np.ndarray,            # i32 [T] identical-request run from each task
    sig_of_task: np.ndarray,        # i32 [T] static row of each task (under sig_compress)
    qfair_share: np.ndarray,        # f32 [Q, K] the ladder's share at rung k ([1, 1] dummy)
    qfair_over: np.ndarray,         # bool [Q, K] the ladder's overused at rung k
    *,
    comparators,
    queue_comparators=(),
    overused_gate: bool = False,
    use_static: bool = False,
    n_queues: int = 0,
    weights,
    enforce_pod_count: bool,
    batch_runs: bool = False,
    sorted_jobs: bool = False,
    has_releasing: bool = True,
    step_kernel: bool = False,
    queue_delta: bool = False,
    sig_compress: bool = False,
    qfair_ladder: bool = False,
    plain_step: bool = False,
    check_every: int = 0,
    mesh=None,
):
    """The JAX engine's ``fused_allocate`` while loop
    (``scheduler_tpu/ops/fused.py:175-1030``), driven from the host, with
    the JAX loop's operands and static arguments (but ``window``).  With
    ``mesh`` (an ``ops/mesh.py`` NodeMesh) and the node operands staged on
    it by ``mesh.shard_fused_args`` (``Sharded`` blocks), the arm of a step
    runs over the shards: K1 on every block (``_K1MeshArm``) or the XLA
    arm's shard mode (``ops/xla_step.py::XlaShardStep``), each merged on
    the host to the one-device codes; where the node bucket does not divide
    the mesh the operands stay whole and, as in the JAX loop, K1 is off.  Returns ``(codes, stats)``: int32 [T] codes on the
    host, bit for bit the JAX loop's, and ``{"arm": "step_kernel" or
    "xla", "steps", "chain_selects": job selections through the comparator
    chain, "k1_ms" / "xla_ms": the arm's summed event time (CUDA only),
    "xla_host_ms": the host clock around the XLA arm's steps,
    "delta_updates" / "full_recomputes" / "ladder_lookups": the queue
    chain's refreshes, one a pop}`` plus, with ``check_every``, the count
    of kernel-versus-plain checks.

    The arm of a step is the JAX loop's: the placement-step kernel
    (``_K1Arm``: a CUDA launch on CUDA operands, its plain version on CPU
    operands or with ``plain_step``) where ``step_kernel`` holds and the
    session has neither releasing capacity nor a live top-2 score bound;
    otherwise the XLA step arm (``ops/xla_step.py``: one ``xla_step`` launch
    a step on CUDA operands, its plain version on CPU operands or with
    ``plain_step``; the joint idle / releasing fit and the pipelined
    codes).  Job selection (the cursor; the comparator chain over
    dirty jobs; in multi-queue and unsorted sessions the queue pop by
    proportion's share and overused gate with the delta, full-recompute or
    ladder chain, then the job chain in the winning queue), batch caps, the
    float32 job and queue ledgers and the codes stay on the host: float32
    IEEE operations in the JAX loop's order give its bits.  The JAX
    ``window`` unrolling is left out: it changes no result (a micro-step
    past the end is a no-op), and here the loop simply stops when the JAX
    liveness condition fails.  ``check_every`` > 0 holds the arm's kernel to
    its plain version (all its outputs, bitwise; the XLA arm's on a clone of
    the node state, and the node state it writes) at the first step and
    every ``check_every``-th one."""
    if set(comparators) - set(_KNOWN_JOB_ORDER):
        raise ValueError(f"unknown job-order comparators {comparators}")
    if set(queue_comparators) - {"proportion"}:
        raise ValueError(f"unknown queue comparators {queue_comparators}")
    from scheduler_tpu_torch.api.vocab import CPU as _CPU_IDX, MEMORY as _MEM_IDX
    from scheduler_tpu_torch.ops.mesh import Sharded
    from scheduler_tpu_torch.ops.xla_step import XlaShardStep, XlaStep

    sharded = isinstance(allocatable, Sharded)
    if sharded and mesh is None:
        raise ValueError("fused_allocate: sharded operands need their mesh")
    dev = mesh.first if sharded else allocatable.device
    n, r_dim = allocatable.shape
    t_cap = resreq.shape[0]
    if mesh is not None and n % mesh.size != 0:
        step_kernel = False  # the node bucket must divide over the mesh
    track_queue_alloc = bool(queue_comparators) or overused_gate
    use_queue_delta = queue_delta and track_queue_alloc
    use_ladder = qfair_ladder and use_queue_delta
    single_queue = n_queues == 1 and not queue_comparators and not overused_gate
    cursor_mode = sorted_jobs and single_queue
    cross_batch = batch_runs and cursor_mode
    binpack_only = weights[0] == 0.0 and weights[1] == 0.0 and weights[2] > 0.0
    score_bound = batch_runs and not binpack_only
    step_kernel = step_kernel and not has_releasing and not score_bound
    static_row = use_static and sig_compress

    offsets = np.asarray(job_task_offset, dtype=np.int64)
    nums = np.asarray(job_task_num, dtype=np.int64)
    deficit = np.asarray(job_deficit, dtype=np.int64)
    gang_order = np.asarray(job_gang_order, dtype=np.int64)
    priority = np.asarray(job_priority, dtype=np.int32)
    tiebreak = np.asarray(job_tiebreak, dtype=np.int32)
    jqueue = np.asarray(job_queue, dtype=np.int64)
    alloc_init = np.asarray(job_alloc_init, dtype=np.float32)
    if cross_batch:
        # Pad the job axis so the cross-job [cur, cur + m) rows never clamp.
        def pad(a, v):
            return np.concatenate([a, np.full((MAX_BATCH,) + a.shape[1:], v, dtype=a.dtype)])

        offsets, nums, deficit, gang_order, jqueue = (
            pad(a, 0) for a in (offsets, nums, deficit, gang_order, jqueue))
        priority, tiebreak = pad(priority, 0), pad(tiebreak, _BIG_I32)
        alloc_init = pad(alloc_init, 0)
    j_cap = nums.shape[0]
    n_real = int((nums > 0).sum())
    nums_f = nums.astype(np.float32)
    gang_f = gang_order.astype(np.float32)
    total = np.asarray(drf_total, dtype=np.float32)
    total_safe = np.where(total > 0, total, np.float32(1.0)).astype(np.float32)
    total_mask = total > 0
    req_h = resreq.cpu().numpy()
    run_l = np.asarray(run_len, dtype=np.int64).tolist()
    offsets_l, nums_l, deficit_l = offsets.tolist(), nums.tolist(), deficit.tolist()
    sig_l = np.asarray(sig_of_task, dtype=np.int64).tolist() if static_row else None
    mins_h = mins.cpu().numpy().astype(np.float32)

    # The queue ledgers (queue_alloc_init, the delta chain's share and
    # overused vectors, the ladder's placement counts), on the host.
    q_rank = np.asarray(queue_rank, dtype=np.int32)
    q_n = q_rank.shape[0]
    q_has_jobs = np.asarray(queue_has_jobs, dtype=bool)
    q_des = np.asarray(queue_deserved, dtype=np.float32)
    q_alloc = np.array(queue_alloc_init, dtype=np.float32)
    jqueue_l = jqueue.tolist()
    if use_queue_delta:
        q_share, q_over = _share_overused(q_des.T, q_alloc.T, mins_h, r_dim)
    else:
        q_share, q_over = np.zeros(q_n, np.float32), np.zeros(q_n, bool)
    q_count = np.zeros(q_n, dtype=np.int64)
    lad_share = np.asarray(qfair_share, dtype=np.float32)
    lad_over = np.asarray(qfair_over, dtype=bool)
    cpumem = np.arange(r_dim) < 2

    # job_state f32 [J, 3 + R]: consumed | n_alloc | left | drf allocated.
    job_state = np.zeros((j_cap, JOB_STATE.DRF + r_dim), dtype=np.float32)
    job_state[:, JOB_STATE.DRF:] = alloc_init
    cross_head = np.zeros(JOB_STATE.DRF + r_dim, dtype=np.float32)
    cross_head[JOB_STATE.CONSUMED] = cross_head[JOB_STATE.ALLOCATED] = 1.0
    out = np.full(t_cap + MAX_BATCH, UNPLACED, dtype=np.int32)
    counts = {"chain_selects": 0, "delta_updates": 0, "full_recomputes": 0,
              "ladder_lookups": 0}

    def eligible(hi: int) -> np.ndarray:
        js = job_state[:hi]
        return (js[:, JOB_STATE.LEFT] == 0) & (js[:, JOB_STATE.CONSUMED] < nums_f[:hi])

    def key_columns(idx: np.ndarray) -> list:
        """The comparator chain's keys of jobs ``idx``, one array a
        comparator in tier order: integer keys kept integer."""
        cols = []
        for name in comparators:
            if name == "priority":
                cols.append(-priority[idx])
            elif name == "gang":
                cols.append(((gang_f[idx] - job_state[idx, JOB_STATE.ALLOCATED]) <= 0)
                            .astype(np.int32))
            else:  # drf
                cols.append(np.where(total_mask[None, :],
                                     job_state[idx, JOB_STATE.DRF:] / total_safe[None, :],
                                     np.float32(0.0)).max(axis=1))
        return cols

    def job_chain(idx: np.ndarray) -> int:
        """The comparator chain over the candidate jobs ``idx`` (ascending):
        a lexicographic argmin, then the tiebreak rank (the lowest index
        among equal ranks); HALT when there is no candidate."""
        if idx.shape[0] == 0:
            return HALT
        cand = np.ones(idx.shape[0], dtype=bool)
        for key in key_columns(idx):
            cand &= key == key[cand].min()
        idx = idx[cand]
        return int(idx[np.argmin(tiebreak[idx])])

    # The pool of the queue pop (outside cursor mode): a heap a queue of its
    # eligible jobs keyed by (chain keys, tiebreak, index), the job chain's
    # lexicographic order.  A job's keys move only with its own placements,
    # so the keys are refreshed when its pop ends, and the heap's first
    # current entry is the chain's winner over the queue's eligible jobs.
    heaps = [[] for _ in range(q_n)]
    version = np.zeros(j_cap, dtype=np.int64)
    elig_now = np.zeros(j_cap, dtype=bool)
    q_elig = np.zeros(q_n, dtype=np.int64)

    def chain_keys(idx: np.ndarray) -> list:
        cols = [col.tolist() for col in key_columns(idx)]
        return list(zip(*cols, tiebreak[idx].tolist(), idx.tolist()))

    def pool_init() -> None:
        elig_now[:] = eligible(j_cap)
        idx = np.flatnonzero(elig_now)
        for key, j in zip(chain_keys(idx), idx.tolist()):
            heaps[jqueue_l[j]].append((key, 0))
            q_elig[jqueue_l[j]] += 1
        for heap in heaps:
            heapq.heapify(heap)

    def pool_update(j: int) -> None:
        """Job ``j``'s pop ended: re-key it, or drop it from its queue's
        eligible count."""
        version[j] += 1
        js = job_state[j]
        if js[JOB_STATE.LEFT] == 0 and js[JOB_STATE.CONSUMED] < nums_f[j]:
            heapq.heappush(heaps[jqueue_l[j]], (chain_keys(np.asarray([j]))[0], version[j]))
        elif elig_now[j]:
            elig_now[j] = False
            q_elig[jqueue_l[j]] -= 1

    def pool_first(q: int) -> int:
        heap = heaps[q]
        while heap:
            key, ver = heap[0]
            j = key[-1]
            if ver == version[j] and elig_now[j]:
                return j
            heapq.heappop(heap)
        return HALT

    def select_job() -> int:
        """The JAX ``select_job`` (``scheduler_tpu/ops/fused.py:496-572``)
        outside cursor mode: the queue pop, then the job chain in the
        winning queue."""
        counts["chain_selects"] += 1
        if single_queue:
            return pool_first(0)
        q_has = (q_elig > 0) & q_has_jobs
        if track_queue_alloc and not use_queue_delta:
            counts["full_recomputes"] += 1
        if overused_gate:
            if use_queue_delta:
                q_has = q_has & ~q_over
            else:
                # deserved.less_equal(allocated) on every dim.
                q_has = q_has & ~((q_des - q_alloc) < mins_h[None, :]).all(axis=1)
        cand_q = q_has
        for _ in queue_comparators:  # proportion
            if use_queue_delta:
                qkey = q_share
            else:
                pos = q_des > 0
                frac = np.where(pos, q_alloc / np.where(pos, q_des, np.float32(1.0)),
                                np.float32(0.0))
                frac = np.where(~pos & cpumem[None, :] & (q_alloc > 0), np.float32(1.0), frac)
                qkey = frac.max(axis=1)
            masked_q = np.where(cand_q, qkey, np.float32(np.inf))
            cand_q = cand_q & (masked_q == masked_q.min())
        # HALT without a selectable queue: guard on any_queue first (an
        # all-sentinel argmin would name queue 0).
        if not q_has.any():
            return HALT
        return pool_first(int(np.argmin(np.where(cand_q, q_rank, np.int32(_BIG_I32)))))

    def refresh(q: int) -> None:
        """The lazy delta refresh of queue ``q``'s share and overused flag
        (``scheduler_tpu/ops/fused.py:616-652``): a rung gather of the
        ladder, or the share chain over its allocated row."""
        if use_ladder:
            counts["ladder_lookups"] += 1
            rung = min(int(q_count[q]), lad_share.shape[1] - 1)
            q_share[q], q_over[q] = lad_share[q, rung], lad_over[q, rung]
        else:
            counts["delta_updates"] += 1
            share, over = _share_overused(q_des[q], q_alloc[q], mins_h, r_dim)
            q_share[q], q_over[q] = share, over

    if sharded:
        if step_kernel:
            arm = _K1MeshArm(mesh, idle, task_count, allocatable, pods_limit, node_gate, mins,
                             init_resreq, resreq, static_mask, static_score,
                             sig_of_task if static_row else np.arange(t_cap), req_h,
                             plain=plain_step, check_every=check_every, r_dim=r_dim,
                             weights=tuple(float(w) for w in weights), use_static=use_static,
                             enforce_pod_count=enforce_pod_count, batch_runs=batch_runs,
                             cpu_idx=_CPU_IDX, mem_idx=_MEM_IDX)
        else:
            arm = XlaShardStep(mesh, idle, releasing, task_count, allocatable, pods_limit,
                               node_gate, mins, init_resreq, resreq, static_mask, static_score,
                               weights=weights, use_static=use_static,
                               enforce_pod_count=enforce_pod_count, has_releasing=has_releasing,
                               batch_runs=batch_runs, score_bound=score_bound, plain=plain_step,
                               check_every=check_every)
    elif step_kernel:
        staged = stage_step_operands(idle, task_count, allocatable, pods_limit, node_gate,
                                     mins, init_resreq, resreq, static_mask, static_score,
                                     sig_of_task if static_row else np.arange(t_cap),
                                     use_static=use_static)
        req8 = np.concatenate([req_h, np.zeros((t_cap, staged[9] - r_dim), np.float32)], axis=1)
        arm = _K1Arm(staged, req8, device=dev, plain=plain_step, check_every=check_every,
                     r_dim=r_dim, weights=tuple(float(w) for w in weights),
                     use_static=use_static, enforce_pod_count=enforce_pod_count,
                     batch_runs=batch_runs, cpu_idx=_CPU_IDX, mem_idx=_MEM_IDX)
    else:
        arm = XlaStep(idle, releasing, task_count, allocatable, pods_limit, node_gate, mins,
                      init_resreq, resreq, static_mask, static_score,
                      weights=weights, use_static=use_static,
                      enforce_pod_count=enforce_pod_count, has_releasing=has_releasing,
                      batch_runs=batch_runs, score_bound=score_bound, plain=plain_step,
                      check_every=check_every)
    cur, cursor, n_dirty, steps, last_q = -1, 0, 0, 0, 0
    n_elig = n_real  # eligible jobs: pending tasks left, no failure yet
    if not cursor_mode:
        pool_init()
    try:
        while True:
            if cur < 0:
                # Liveness, then the selection of the next pop; a HALT ends
                # the action.
                if cursor_mode:
                    # Every eligible job is fresh (past the cursor), dirty,
                    # or in its pop.
                    if not (cursor < n_real or n_dirty > 0):
                        break
                    cursor0 = cursor
                    if n_dirty > 0:
                        # The comparator chain over the dirty jobs and the
                        # cursor head (indices <= cursor0).
                        counts["chain_selects"] += 1
                        sel = job_chain(np.flatnonzero(eligible(min(cursor0 + 1, j_cap))))
                    else:
                        sel = cursor0
                    if sel < 0:
                        break
                    if sel == cursor0:
                        cursor += 1
                    else:
                        n_dirty -= 1  # a chain winner off the head is a dirty job
                else:
                    if n_elig == 0:
                        break
                    if use_queue_delta:
                        refresh(last_q)
                    sel = select_job()
                    if sel < 0:
                        break
                cur = sel
            steps += 1
            if steps > t_cap:
                raise RuntimeError("fused_allocate: the loop outran its task count")
            t_idx = min(max(offsets_l[cur] + int(job_state[cur, JOB_STATE.CONSUMED]), 0),
                        t_cap - 1)
            single_pop = nums_l[cur] == 1
            hi0 = 1
            if batch_runs:
                d = deficit_l[cur]
                room = d - int(job_state[cur, JOB_STATE.ALLOCATED]) if d > 0 else 1
                if cross_batch and single_pop and n_dirty == 0:
                    room = MAX_BATCH  # cross-job run of one-task pops
                hi0 = min(run_l[t_idx], MAX_BATCH, room)
            best, feasible, alloc_here, pipe_here, m = arm.step(
                t_idx, sig_l[t_idx] if static_row else t_idx, hi0)
            q_idx = jqueue_l[cur]
            if not feasible:
                # First infeasible task: the pop ends, the job leaves.
                job_state[cur, :JOB_STATE.DRF] += (1.0, 0.0, 1.0)
                job_state[cur, JOB_STATE.DRF:] += np.float32(0.0) * req_h[t_idx]
                out[t_idx] = FAILED
                if track_queue_alloc and use_queue_delta:
                    last_q = q_idx
                n_elig -= 1
                if not cursor_mode:
                    pool_update(cur)
                cur = -1
                continue
            # Placed: m copies on idle, or one pipelined onto releasing.
            copies = m if alloc_here else 1
            pc = np.float32(copies)
            if cross_batch and single_pop and alloc_here:
                # m one-task pops at once: rows [cur, cur + m) each consume,
                # allocate and add their request; the cursor retires them.
                cross_head[JOB_STATE.DRF:] = req_h[t_idx]
                job_state[cur:cur + m] += cross_head
                cursor += m - 1
            else:
                job_state[cur, :JOB_STATE.DRF] += (copies, m if alloc_here else 0, 0.0)
                job_state[cur, JOB_STATE.DRF:] += pc * req_h[t_idx]
            out[t_idx:t_idx + copies] = best if alloc_here else _PIPE_BASE - best
            if track_queue_alloc:
                # proportion's allocate handler: the queue's allocated grows
                # by every copy, pipelined ones too (the ladder counts them).
                if use_ladder:
                    q_count[q_idx] += copies
                else:
                    q_alloc[q_idx] += pc * req_h[t_idx]
                if use_queue_delta:
                    last_q = q_idx
            became_ready = job_state[cur, JOB_STATE.ALLOCATED] >= deficit_l[cur]
            drained = job_state[cur, JOB_STATE.CONSUMED] >= nums_l[cur]
            if drained:
                n_elig -= 1
            if became_ready or drained:
                if cursor_mode and became_ready and not drained:
                    n_dirty += 1  # ready with a tail: re-enters the pool
                if not cursor_mode:
                    pool_update(cur)
                cur = -1
    finally:
        arm.close()
    stats = {"arm": "step_kernel" if step_kernel else "xla", "steps": steps,
             "shards": mesh.size if sharded else 1,
             "k1_ms": arm.k1_ms if step_kernel else None,
             "xla_ms": None if step_kernel else arm.xla_ms,
             "xla_host_ms": None if step_kernel else arm.host_ms, **counts}
    if check_every:
        stats["checked"] = arm.checked
    return torch.from_numpy(out[:t_cap].copy()), stats


class FusedAllocator:
    """Host shim: session -> tensors -> the mega kernel or the loop ->
    decoded rows.

    Built once for a session and kept across cycles by the engine cache
    (``ops/engine_cache.py``): ``update`` re-points a resident engine at a
    new session whose layout token matches, refreshing only the dynamic
    node state and proportion's queue rows.  ``engine`` says which engine
    the JAX gates chose; setting ``use_mega = False`` on an engine that
    chose the mega kernel runs the loop on the same session instead (as the
    JAX tests do).  Execution is split into ``dispatch`` and a blocking
    ``readback``; the mega kernel's dispatch does not block, so callers can
    overlap host work with the device."""

    def __init__(self, ssn, jobs: Sequence[JobInfo], device=None) -> None:
        self.device = resolve_device(device)
        self.ssn = ssn
        # Cross-cycle state (reset here, so a rebuild in place through
        # ``update`` keeps nothing of the engine it replaces).
        self._layout_token = None  # ops/engine_cache.py layout fingerprint
        self._job_uids = None      # survives release(); _rebind restores jobs
        self._dev = None          # in-flight device codes (dispatch pending)
        self._dev_stats = None    # in-flight evidence counters
        self._stats_raw = None    # collected evidence of the last readback
        self._encoded = None      # decoded int32 codes of the last readback
        self._events = None       # CUDA events around the in-flight launch
        self.kernel_ms = None     # the kernel's device time in the last run (CUDA only)
        self.loop_ms = None       # the whole loop of the last step-engine run (CUDA only)
        # Cohort evidence: host-side cohort table summary + chunk count.
        self.cohort_count = 0     # maximal identical-shape runs of length >= 2
        self.cohort_tasks = 0     # tasks covered by those runs
        self.cohort_spill = False  # some cohort must split across nodes
        self.cohort_chunks = _cohort_chunks(self.device)
        self.cohort_effective = 1  # chunks the kernel actually runs
        # Allocator flavor (ops/lp_place.py): resolved once a build; whether
        # the LP flavor runs (``use_lp``) waits for its admission gate.
        from scheduler_tpu_torch.ops.lp_place import allocator_flavor

        self.allocator = allocator_flavor()
        self.use_lp = False
        self.lp_reason = None         # why lp fell back to greedy, if it did
        self._lp_stats_host = None    # (pref, lp_raw) of the last run, on the host
        self._lp_static = None        # the relaxation's static rows ([S] or [T], N)
        self.lp_phase = {}            # lp_iterate / lp_repair wall seconds of the last run
        self.lp_ms = None             # the relaxation's device time (CUDA events)
        self._req_sigs = None         # (scaled requests, signature ids, unique rows)
        self._req_init = None         # the scaled init requests beside them
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
        # The engine cache's refresh state: the padded, scaled host copies of
        # the dynamic node tensors a hit refreshes, their device twins (the
        # mega kernel's; the loop reads the host copies) with an ownership
        # flag each, the dirty-set epoch they mirror, and proportion's rows.
        # A device twin starts as a shared transfer-cache resident (not
        # owned); the first change replaces it with the engine's own copy,
        # which later refreshes may write in place.
        self._scale = scale
        self._host_dyn = {
            "idle": pad_rows(scale_columns(st.nodes.idle, scale), nb),
            "releasing": pad_rows(scale_columns(st.nodes.releasing, scale), nb),
            "task_count": pad_rows(st.nodes.task_count.astype(np.int32), nb),
        }
        self._dyn_dev: Optional[Dict[str, torch.Tensor]] = None
        self._dyn_owned = {name: False for name in _DYNAMIC}
        self._refresh_epoch = getattr(ssn, "dirty_epoch", -1)
        self._node_index: Optional[dict] = None
        self._mega_qpack = None   # (queue of each job lane, j_pad, jb) in multi-queue mode
        self._ladder_ctx = None   # (request rows, counts, mins, qb) of the ladder's tables

        node_gate = pad_rows(st.nodes.ready, nb, fill=False)
        total = st.nodes.allocatable.sum(axis=0)

        # Session-static [T, N] mask/score, combined and padded on the
        # device (size-gated by ``supported``); timed as a part of the
        # engine build.
        static_mask_dev = static_score_dev = None
        if self.use_static and t_total > 0:
            with phases.phase("engine_init.static_tensors"):
                static_mask_dev, static_score_dev = build_static_tensors_device(
                    ssn, st, nb, tb, self.device
                )

        # Run lengths: consecutive tasks with identical request rows, counted
        # from each position — the kernel batches a whole run per placement
        # step.  Runs stay within one job, EXCEPT that consecutive
        # single-task jobs merge in cursor mode.  With static tensors a run
        # must also share its mask/score rows (same requests do not imply
        # same selectors); that equality is checked on the device.
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
                merge = merge_host
                if self.use_static:
                    same_rows = (
                        (static_mask_dev[1:t_count] == static_mask_dev[: t_count - 1]).all(dim=1)
                        & (static_score_dev[1:t_count] == static_score_dev[: t_count - 1]).all(dim=1)
                    )
                    merge = merge & same_rows.cpu().numpy()
                # run[i] = distance to the next break: boundary i sits between
                # tasks i and i+1; a reverse running minimum over break
                # positions gives the first break at-or-after every position.
                idx = np.arange(t_count, dtype=np.int32)
                cand = np.where(merge, np.int32(t_count), idx[1:])
                next_brk = np.minimum.accumulate(cand[::-1])[::-1]
                run = np.concatenate([next_brk - idx[: t_count - 1], [1]])
                run_host[:t_count] = np.clip(run, 1, MAX_BATCH)

        self.batch_runs = merge_any
        self.has_releasing = bool(np.any(st.nodes.releasing))
        self.enforce_pod_count = "pod_count" in ssn.device_dynamic_gates
        # Static rows by static signature: one [N] mask and score row per
        # signature, for the mega kernel's static-row mode and the loop.
        static_sids = (self._static_signature_ids(ssn)
                       if self.use_static and t_total > 0 else None)
        with phases.phase("engine_init.sig_classes"):
            self._stage_classes(static_sids, queues_idx, priorities, scale, tb, r)

        # --- the queue chain: proportion's deserved / allocated rows --------
        # (scheduler_tpu/ops/fused.py:1551-1571), in queue-rank order, scaled
        # to device units, and the qfair class ladder where it is exact.
        from scheduler_tpu_torch.ops import qfair as _qf

        self.queue_delta = _queue_delta_enabled()
        self.qfair_flavor = _qf.qfair_flavor()
        self.qfair_ladder = False   # the ladder is built (the session admits it)
        self.qfair_reason = None    # why it was not
        self._qfair = {}            # proportion's evidence block
        self._ladder_host = None    # (share f32 [qb, K], overused bool [qb, K])
        queue_deserved = np.zeros((len(queue_names), r), dtype=np.float64)
        queue_alloc = np.zeros((len(queue_names), r), dtype=np.float64)
        if self.queue_comparators or self.overused_gate:
            fair = ssn.device_queue_fair["proportion"](queue_names)
            queue_deserved[:] = scale_columns(fair["deserved"], scale)
            queue_alloc[:] = scale_columns(fair["allocated"], scale)
            self._qfair = dict(fair.get("qfair", {}))
            self._build_qfair_ladder(policy, queue_deserved, queue_alloc, queues_idx,
                                     bucket(len(queue_names)), r, scale)
        self._host_queue_fair = (queue_deserved, queue_alloc)

        # --- the node mesh (scheduler_tpu/ops/fused.py:1619-1624) -----------
        # ``SCHEDULER_TORCH_MESH`` / ``--mesh``: the node axis over a device
        # list (ops/mesh.py; None: one device).  Its devices must be of the
        # session's kind; the first holds every replicated operand.
        from scheduler_tpu_torch.ops.mesh import get_mesh

        mesh = get_mesh()
        if mesh is not None and mesh.first.type != self.device.type:
            raise ValueError(f"the node mesh lies on {mesh.first.type} devices but the session "
                             f"runs on {self.device}")
        self._mesh = mesh
        self._lp_mesh = None

        # --- the LP flavor's admission (scheduler_tpu/ops/fused.py:1626-1662) -
        # Releasing sessions and working sets past the limit keep greedy
        # (logged once a build).  Where it engages, neither single-step
        # kernel runs: the relaxation is the data-parallel stage and the
        # repair runs the loop's XLA step arm.
        if self.allocator == "lp":
            from scheduler_tpu_torch.ops import lp_place

            self.use_lp, self.lp_reason = lp_place.lp_supported(
                self.flat_count, self.has_releasing, self._sig_bucket, nb, mesh)
            # The relaxation runs over node blocks only where the staged
            # operands split (a bucket that does not divide stays whole).
            self._lp_mesh = mesh if mesh is not None and nb % mesh.size == 0 else None
            if self.use_lp:
                self._stage_lp_static(static_mask_dev, static_score_dev)
            else:
                # An empty pending set is an idle scheduler, not a degraded
                # configuration.
                log = logger.debug if self.flat_count == 0 else logger.warning
                log("SCHEDULER_TORCH_ALLOCATOR=lp unavailable (%s); falling back to greedy",
                    self.lp_reason)

        # --- engines: the mega kernel and the loop with K1 --------------------
        binpack_only = (
            self.weights[0] == 0.0
            and self.weights[1] == 0.0
            and self.weights[2] > 0.0
        )
        score_bound = self.batch_runs and not binpack_only
        # The JAX engine's step-kernel gate (scheduler_tpu/ops/fused.py:1670-1691):
        # the loop can run its selection as the placement-step kernel unless
        # the session has releasing capacity, the top-2 score bound needs the
        # whole masked-score vector or the node state outgrows the kernel's
        # budget.
        r8 = -(-r // 8) * 8
        nb_local = nb // mesh.size if mesh is not None and nb % mesh.size == 0 else nb
        self.step_kernel = bool(
            not self.use_lp
            and (mesh is None or nb % mesh.size == 0)
            and not self.has_releasing
            and not score_bound
            and (2 * r8 + 12) * nb_local * 4 <= 8 * 1024 * 1024
        )
        mins_f32 = np.asarray(policy.scaled_mins(r), dtype=np.float32)
        # The loop's operands, staged lazily (``args``): a session that runs
        # the mega kernel never builds them.
        self._args = None
        # The loop reads static rows by static signature (sig_of_task).
        self._sig_compress = static_sids is not None
        self._args_parts = (
            scale, node_gate, total, offsets, nums, deficits, gang_order, priorities,
            tiebreak, queues_idx, alloc_init, queue_deserved, queue_alloc, run_host,
            static_sids, static_mask_dev, static_score_dev, mins_f32,
        )
        self.use_mega = False
        # Multi-queue sessions run the kernel's queue-chain mode: proportion
        # is the only queue chain it knows (scheduler_tpu/ops/fused.py:1709).
        mq_ok = not single_queue and set(self.queue_comparators) <= {"proportion"}
        mega_ok = not self.use_lp and _mk.mega_supported(
            has_releasing=self.has_releasing,
            use_static=False,
            score_bound=score_bound,
            cursor_mode=single_queue,
            multi_queue=mq_ok,
            r_dim=r,
            n=nb,
            n_sigs=1,  # signature count checked after the table builds
            comparators=self.comparators,
        )
        if mega_ok and self.use_static and t_total > 0:
            mega_ok = static_sids is not None and _mk.mega_supported(
                has_releasing=self.has_releasing,
                use_static=True,
                score_bound=score_bound,
                cursor_mode=single_queue,
                multi_queue=mq_ok,
                r_dim=r,
                n=nb,
                n_sigs=1,
                comparators=self.comparators,
                n_static_sigs=int(static_sids.max()) + 1 if static_sids.size else 0,
            )
        if mega_ok:
            self._prepare_mega(
                policy, scale, nb, tb, r, offsets, nums, deficits,
                gang_order, priorities, tiebreak, alloc_init, total, run_host,
                score_bound, static_sids, static_mask_dev, static_score_dev,
                single_queue, queues_idx, queue_deserved, queue_alloc,
            )

    def _request_signatures(self, scale):
        """``(req_s, inverse, uniq_rows)``: the tasks' scaled request rows
        and their request-signature ids over (request, init request), built
        once for the ladder's admission and the mega kernel's table."""
        if self._req_sigs is None:
            t = self.flat_count
            req_s = np.asarray(scale_columns(self.st.tasks.resreq[:t], scale), dtype=np.float32)
            init_s = np.asarray(
                scale_columns(self.st.tasks.init_resreq[:t], scale), dtype=np.float32)
            inverse, uniq_rows = _mk.request_signature_ids(req_s, init_s)
            self._req_sigs = (req_s, inverse, uniq_rows)
            self._req_init = init_s
        return self._req_sigs

    def _stage_classes(self, static_sids, queues_idx, priorities, scale, tb: int,
                       r: int) -> None:
        """Signature classes (``scheduler_tpu/ops/fused.py:1469-1550``):
        ``sig_of_task``, ``class_count``, the row bucket of the staged rows
        (``_sig_bucket``: ``bucket(S)`` under classes, else the task
        bucket) and the ``[S]``-class LP operands padded to ``bucket(S)``
        with zero count, so pad classes carry no load.  The decisions and
        reasons are the JAX engine's.  The greedy engines keep reading
        static rows by static signature, so classes change no greedy
        operand."""
        from scheduler_tpu_torch.ops import sig_compress as _sc

        t_total = self.flat_count
        self.sig_mode = _sc.sig_compress_mode()
        self.sig_compress = False
        self.sig_reason = None
        self.sig_classes = 0
        self.sig_of_task = None      # np i32 [T] class id per flat task
        self.class_count = None      # np i32 [S] tasks per class
        self._sig_bucket = tb        # row bucket of the LP rows
        self._lp_sig_host = None     # (init_c, req_c, count_c) [sb] class operands
        self._lp_sig_dev = None      # their device twins (staged at the first LP run)
        self._lp_rep_rows = None     # i64 [sb] each class row's representative task
        if self.sig_mode == "off" or t_total == 0:
            return
        if self.use_static and static_sids is None:
            self.sig_reason = "unknown static builders (no per-task static signature)"
            return
        req_s, inverse, _ = self._request_signatures(scale)
        init_s = self._req_init
        jidx = self.st.tasks.job_idx[:t_total]
        sig_of_task, class_count, rep_rows = _sc.derive_classes(
            inverse, static_sids, queues_idx[jidx], priorities[jidx])
        s_count = class_count.shape[0]
        if self.sig_mode == "auto" and s_count >= t_total:
            # auto pays the indirection only where something dedupes; "on"
            # forces the degenerate S == T shape.
            self.sig_reason = "no repeated signatures (S == T)"
            return
        self.sig_compress = True
        self.sig_classes = s_count
        self.sig_of_task = sig_of_task
        self.class_count = class_count
        sb = bucket(s_count)
        self._sig_bucket = sb
        init_c = np.zeros((sb, r), dtype=np.float32)
        init_c[:s_count] = init_s[rep_rows]
        req_c = np.zeros((sb, r), dtype=np.float32)
        req_c[:s_count] = req_s[rep_rows]
        count_c = np.zeros(sb, dtype=np.float32)
        count_c[:s_count] = class_count
        self._lp_sig_host = (init_c, req_c, count_c)
        # Pad class rows repeat class 0's static rows (never read: their
        # count is 0), as gather_signature_rows pads them.
        self._lp_rep_rows = np.concatenate(
            [rep_rows, np.full(sb - s_count, rep_rows[0], dtype=np.int64)])

    def _stage_lp_static(self, static_mask_dev, static_score_dev) -> None:
        """The relaxation's static rows: the per-task [T, N] rows (pad task
        rows infeasible), or one row a class under classes; ``None`` without
        static rows."""
        if static_mask_dev is None:
            return
        if self.sig_compress:
            rep = torch.as_tensor(self._lp_rep_rows, device=self.device)
            self._lp_static = (static_mask_dev[rep].contiguous(),
                               static_score_dev[rep].contiguous())
        else:
            self._lp_static = (static_mask_dev, static_score_dev)

    def _build_qfair_ladder(self, policy, queue_deserved, queue_alloc, queues_idx, qb, r,
                            scale) -> None:
        """The qfair ladder's admission and tables, as the JAX engine builds
        them (``scheduler_tpu/ops/fused.py:1814-1887``; its decline reasons
        word for word).  The ladder is exact where every queue's candidates
        share one request signature and a step places one copy: a queue's
        allocated row after k placements is then the delta chain's float32
        fold as a function of k alone.  ``qb`` is the queue count's bucket,
        the tables' queue axis."""
        from scheduler_tpu_torch.ops import qfair as _qf

        t_total = self.flat_count
        reason = None
        if not self.queue_delta:
            reason = "queue delta chain disabled"
        elif self.qfair_flavor != "device":
            # The JAX engine's words, kept for parity: in the port the
            # kill-switch is SCHEDULER_TORCH_QFAIR=host.
            reason = "SCHEDULER_TPU_QFAIR=host (kill-switch)"
        elif t_total == 0:
            reason = "no pending tasks"
        elif self.has_releasing:
            reason = "releasing capacity (pipeline arm)"
        elif self.batch_runs:
            reason = "run batching (multi-copy placements)"
        if reason is not None:
            self.qfair_reason = reason
            return
        req_s, inverse, _ = self._request_signatures(scale)
        q_of_task = np.asarray(queues_idx[self.st.tasks.job_idx[:t_total]], dtype=np.int64)
        ok, counts, _ = _qf.single_class_queues(inverse, q_of_task, qb)
        if not ok:
            self.qfair_reason = "mixed request classes within a queue"
            return
        k_n = int(counts.max(initial=0)) + 1
        if k_n > _qf.LADDER_CAP:
            self.qfair_reason = f"ladder depth {k_n} past cap {_qf.LADDER_CAP}"
            return
        req_rows = np.zeros((qb, r), dtype=np.float32)
        uq, first = np.unique(q_of_task, return_index=True)
        req_rows[uq] = req_s[first]
        self._ladder_ctx = (req_rows, counts,
                            np.asarray(policy.scaled_mins(r), dtype=np.float32), qb)
        self._ladder_host = self._ladder_tables(queue_deserved, queue_alloc)
        self.qfair_ladder = True

    def _ladder_tables(self, queue_deserved, queue_alloc):
        """The ladder's rung tables from proportion's scaled deserved and
        allocated rows ([Q, R]): a pure function of those rows and the
        request classes the build admitted."""
        from scheduler_tpu_torch.ops import qfair as _qf

        req_rows, counts, mins_f32, qb = self._ladder_ctx
        r = req_rows.shape[1]
        q_n = queue_deserved.shape[0]
        des = np.zeros((qb, r), dtype=np.float32)
        des[:q_n] = queue_deserved
        held = np.zeros((qb, r), dtype=np.float32)
        held[:q_n] = queue_alloc
        return _qf.build_ladder(des, held, req_rows, counts, mins_f32, r)

    def _pack_mega_ladder(self):
        """The ladder in the mega kernel's table layout: rung on the rows
        (padded to 8), queue index on the 128 columns, overused as float32
        1.0 / 0.0."""
        l_share, l_over = self._ladder_host
        q_n, k_n = l_share.shape
        k_pad = -(-k_n // 8) * 8
        qf_share = np.zeros((k_pad, 128), dtype=np.float32)
        qf_share[:k_n, :q_n] = l_share.T
        qf_over = np.zeros((k_pad, 128), dtype=np.float32)
        qf_over[:k_n, :q_n] = l_over.T.astype(np.float32)
        return qf_share, qf_over

    def _node_state(self, scale) -> Dict[str, np.ndarray]:
        """Padded, unit-scaled host node columns (device units): the
        dynamic ones are the refresh state's host copies."""
        st, nb = self.st, self.n_bucket
        return dict(
            self._host_dyn,
            allocatable=pad_rows(scale_columns(st.nodes.allocatable, scale), nb),
            pods_limit=pad_rows(st.nodes.pods_limit.astype(np.int32), nb),
        )

    def _static_signature_ids(self, ssn) -> Optional[np.ndarray]:
        """Dense per-task STATIC-signature ids (``ops/backfill.py``
        ``_static_signature_ids``), so the mega kernel keeps a small
        per-signature table instead of the [T, N] matrices.  Any device
        builder but predicates/nodeorder returns None and the session
        closes the mega gate."""
        if (set(ssn.device_predicates) | set(ssn.device_scorers)) - {
            "predicates", "nodeorder"
        }:
            return None
        from scheduler_tpu_torch.ops.backfill import _static_signature_ids

        return _static_signature_ids(self.st, self.flat_count)

    def _prepare_mega(self, policy, scale, nb, tb, r,
                      offsets, nums, deficits, gang_order, priorities,
                      tiebreak, alloc_init, total, run_host,
                      score_bound, static_sids, static_mask_dev,
                      static_score_dev, single_queue, queues_idx,
                      queue_deserved, queue_alloc) -> None:
        """Stage the mega kernel's operands on the device — per-signature
        request table, lane-packed job columns, transposed node rows, the
        per-static-signature mask/score rows in static-row mode and the
        queue operands in multi-queue mode — and its static arguments.  Sets
        ``use_mega`` only if the signature table fits the kernel's cap of
        4,096."""
        from scheduler_tpu_torch.api.vocab import CPU as _CPU_IDX, MEMORY as _MEM_IDX

        t = self.flat_count
        if t == 0:
            return  # nothing pending: no launch
        _, inverse, uniq_rows = self._request_signatures(scale)
        s_count = uniq_rows.shape[0]
        if s_count > 4096:
            return  # the mega gate closes (scheduler_tpu/ops/fused.py:1935-1936)
        node_gate = self._args_parts[1]
        state = self._node_state(scale)
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

        # Mesh mode runs the kernel replicated (scheduler_tpu/ops/fused.py:
        # 2048-2060): every operand whole on the mesh's first device.
        dev = self._mesh.first if self._mesh is not None else self.device

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return _to_device(a, device=dev)

        t_rows = _mk.task_table_rows(tb)
        run2 = np.ones(t_rows * 128, dtype=np.int32)
        run2[:tb] = run_host
        # The idle and releasing ledgers at the same column scale
        # (scheduler_tpu/ops/fused.py:1587, :2041-2044), from the dynamic
        # node tensors' device twins (shared residents until a refresh
        # changes them).
        self._dyn_dev = {name: to_dev(state[name]) for name in _DYNAMIC}
        ns0, rel0 = _mk.build_node_ledgers(
            self._dyn_dev["idle"], self._dyn_dev["task_count"], self._dyn_dev["releasing"], nb,
            r, self.has_releasing)
        alloc_t = torch.zeros((8, nb), dtype=torch.float32, device=dev)
        alloc_t[:r] = to_dev(state["allocatable"]).T
        use_static = static_sids is not None
        if use_static:
            # Per-signature static rows: each static signature's [N] mask and
            # score row, gathered on the device from its first task's row of
            # the [T, N] tensors, plus the per-task signature-id column.
            n_static = int(static_sids.max()) + 1 if static_sids.size else 1
            rows_pad = max(8, -(-n_static // 8) * 8)
            _, first_rows = np.unique(static_sids, return_index=True)
            rep = torch.as_tensor(first_rows.astype(np.int64), device=dev)
            smask = torch.zeros((rows_pad, nb), dtype=torch.float32, device=dev)
            smask[:n_static] = static_mask_dev[rep].to(torch.float32)
            sscore = torch.zeros((rows_pad, nb), dtype=torch.float32, device=dev)
            sscore[:n_static] = static_score_dev[rep]
            msig = _mk.pack_task_table_i32(static_sids.astype(np.int32), tb)
        else:
            smask = torch.zeros((8, nb), dtype=torch.float32, device=dev)
            sscore = torch.zeros((8, nb), dtype=torch.float32, device=dev)
            msig = _mk.pack_task_table_i32(np.zeros(0, np.int32), tb)
        # Multi-queue mode (scheduler_tpu/ops/fused.py:2001-2040): each job
        # lane carries its queue's index (which is also the queue's rank)
        # and that queue's deserved and allocated-at-open rows; the qfair
        # ladder's rung tables, where it is built and the queue count's
        # bucket fits their 128 columns.  Otherwise minimum-size dummies.
        zeros8 = np.zeros((8, 128), dtype=np.float32)
        mega_ladder = (not single_queue and self.qfair_ladder
                       and bucket(len(self.queue_uids)) <= 128)
        qf_share, qf_over = self._pack_mega_ladder() if mega_ladder else (zeros8, zeros8)
        if single_queue:
            jqueue = np.zeros((1, 128), dtype=np.int32)
            jq_des = jq_alloc0 = zeros8
        else:
            jq = queues_idx[:jb].astype(np.int32)
            self._mega_qpack = (jq, j_pad, jb)
            jqueue = _mk.pack_lane_i32(jq, j_pad)
            jq_des = np.zeros((8, j_pad), dtype=np.float32)
            jq_des[:r, :jb] = np.asarray(queue_deserved, dtype=np.float32)[jq].T
            jq_alloc0 = np.zeros((8, j_pad), dtype=np.float32)
            jq_alloc0[:r, :jb] = np.asarray(queue_alloc, dtype=np.float32)[jq].T
        self._mega_args = (
            ns0,
            alloc_t,
            rel0,
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
            to_dev(msig),
            smask,
            sscore,
            to_dev(jqueue),
            to_dev(jq_des),
            to_dev(jq_alloc0),
            to_dev(qf_share),
            to_dev(qf_over),
            to_dev(misc),
        )
        mins_f32 = np.asarray(policy.scaled_mins(r), dtype=np.float32)
        # Cohort chunks engage only where a run can continue past a node's
        # capacity cut: run batching live, no releasing ledger (the kernel
        # runs one chunk a step with it) AND the host spill estimate says
        # some cohort must actually split across nodes
        # (scheduler_tpu/ops/fused.py:2103-2114).
        cohort_eff = (self.cohort_chunks
                      if (self.batch_runs and not self.has_releasing and self.cohort_spill)
                      else 1)
        self.cohort_effective = cohort_eff
        self._mega_kw = dict(
            r_dim=r,
            weights=self.weights,
            enforce_pod_count=self.enforce_pod_count,
            comparators=self.comparators,
            # Cross-job batching needs the cursor invariant: one queue only.
            cross_batch=self.batch_runs and single_queue,
            batch_runs=self.batch_runs,
            has_releasing=self.has_releasing,
            use_static=use_static,
            score_bound=score_bound,
            mins=tuple(float(x) for x in mins_f32),
            cpu_idx=_CPU_IDX,
            mem_idx=_MEM_IDX,
            multi_queue=not single_queue,
            queue_proportion="proportion" in self.queue_comparators,
            overused_gate=self.overused_gate,
            queue_delta=self.queue_delta,
            qfair_ladder=mega_ladder,
            cohort=cohort_eff,
            t_cap=tb,
            mesh=self._mesh,
        )
        self.use_mega = True

    # -- the cross-cycle half (ops/engine_cache.py's hit path) ----------------

    def update(self, ssn, jobs: Sequence[JobInfo], token, eager_dispatch: bool = False) -> str:
        """Re-point this resident engine at a new session
        (``scheduler_tpu/ops/fused.py:2142-2198``).

        When the session's layout token equals the one this engine was built
        from, only the dynamic node tensors (idle, releasing, task counts:
        compared by value and written where they changed) and proportion's
        queue rows refresh, the tensors derived from them are rebuilt (K2's
        node ledgers, its queue lanes and the ladder's tables, the loop's
        node and queue operands), and the host bookkeeping rebinds to the
        new session's job clones.  Any mismatch, or any failure on the delta
        path (logged), rebuilds the engine in place.  With
        ``eager_dispatch`` the engine starts its run before the rebind: the
        mega kernel's launch does not block, so the rebind's host time
        overlaps the kernel and lands in the ``overlap_host`` phase; the
        loop engines' dispatch runs the whole loop first, so their overlap
        is 0.  Returns ``"hit"`` or ``"rebuild"``."""
        import time as _time

        try:
            delta_ok = (
                token is not None
                and token == self._layout_token
                and self._delta_compatible(ssn)
                and self._refresh_dynamic(ssn)
            )
        except Exception:
            logger.exception("engine delta update failed; rebuilding")
            delta_ok = False
        if not delta_ok:
            self.__init__(ssn, jobs, device=_session_device(ssn))
            self._layout_token = token
            return "rebuild"
        try:
            self._dev = self._dev_stats = self._stats_raw = self._encoded = None
            self._events = None
            self.kernel_ms = self.loop_ms = self.lp_ms = None
            self._lp_stats_host = None
            self.lp_phase = {}
            if eager_dispatch:
                # The dispatch reads only the staged operands, never the jobs.
                self.dispatch()
                t0 = _time.perf_counter()
                self._rebind(ssn)
                overlap = _time.perf_counter() - t0 if self.use_mega else 0.0
                phases.add("overlap_host", overlap)
            else:
                self._rebind(ssn)
        except Exception:
            logger.exception("engine rebind failed; rebuilding")
            self.__init__(ssn, jobs, device=_session_device(ssn))
            self._layout_token = token
            return "rebuild"
        return "hit"

    def _rebind(self, ssn) -> None:
        """Point the host bookkeeping at the new session's clones.  The
        layout token guarantees uid-for-uid identical job stores, so the
        pending row indices and every tensor derived from them stay valid;
        the task tensors' lazy columns gather from the new stores."""
        uids = self._job_uids if self.jobs is None else [j.uid for j in self.jobs]
        self.ssn = ssn
        self.jobs = [ssn.jobs[u] for u in uids]
        self._job_uids = uids
        tasks = self.st.tasks
        tasks._uid_fragments = [(job.store, rows) for job, rows in zip(self.jobs, self.job_rows)]
        tasks._cores = tasks._uids = tasks._index = None

    def release(self) -> None:
        """Drop every reference into the closing session: the session, its
        job clones and the task objects the task tensors gather from.  A
        resident engine keeps its tensors and host layout only; ``_rebind``
        restores the rest on the next hit."""
        if self.jobs is not None:
            self._job_uids = [j.uid for j in self.jobs]
        self.ssn = None
        self.jobs = None
        tasks = self.st.tasks
        tasks._uid_fragments = None
        tasks._cores = tasks._uids = tasks._index = None

    def _delta_compatible(self, ssn) -> bool:
        """Cheap structural re-checks guarding the delta path
        (``scheduler_tpu/ops/fused.py:2220-2324`` but the tenant regime,
        which this package does not carry, and the eviction and
        backfill flavors, which never change this engine's program).  The cache key and the layout token pin all
        of them in the cached flow; these re-checks cover direct callers.  A
        mesh engine refreshes too, on the same mesh only (the topology is in
        the cache key)."""
        from scheduler_tpu_torch.ops.mesh import get_mesh

        if _session_device(ssn) != self.device:
            return False
        if get_mesh() is not self._mesh:
            return False
        if self.weights != score_weights(ssn):
            return False
        comparators = tuple(
            name
            for tier in ssn.tiers
            for plugin in tier.plugins
            if plugin.job_order_enabled() and (name := plugin.name) in ssn.job_order_fns
        )
        if comparators != self.comparators:
            return False
        queue_comparators = tuple(
            name
            for tier in ssn.tiers
            for plugin in tier.plugins
            if plugin.queue_order_enabled()
            and (name := plugin.name) in ssn.queue_order_fns
        )
        if queue_comparators != self.queue_comparators:
            return False
        overused = any(
            plugin.name in ssn.overused_fns
            for tier in ssn.tiers
            for plugin in tier.plugins
        )
        if overused != self.overused_gate:
            return False
        if self.use_static != bool(ssn.device_predicates or ssn.device_scorers):
            return False
        if self.enforce_pod_count != ("pod_count" in ssn.device_dynamic_gates):
            return False
        if self.queue_delta != _queue_delta_enabled():
            return False
        from scheduler_tpu_torch.ops.qfair import qfair_flavor

        if self.qfair_flavor != qfair_flavor():
            return False
        from scheduler_tpu_torch.ops.lp_place import allocator_flavor
        from scheduler_tpu_torch.ops.sig_compress import sig_compress_mode

        # The flavor selects which program this engine staged, and the mode
        # its class rows and the LP program's class weighting.
        if self.allocator != allocator_flavor():
            return False
        if self.sig_mode != sig_compress_mode():
            return False
        queue_names = sorted(
            ssn.queues, key=lambda q: (ssn.queues[q].creation_timestamp, q)
        )
        return queue_names == self.queue_uids

    def _refresh_dynamic(self, ssn) -> bool:
        """Bring the dynamic node tensors and proportion's queue rows up to
        the new session (``scheduler_tpu/ops/fused.py:2326-2409``).  Returns
        False when the refresh cannot keep the engine's program: releasing
        capacity appeared or vanished (it selects K2's releasing mode and the
        loop's releasing arm), in which case the caller rebuilds.

        Two node paths: when the cache names the nodes dirtied after this
        engine's last refresh, only those rows are gathered, compared and
        written (the steady state: a few rows of thousands); otherwise (the
        ``SCHEDULER_TORCH_DIRTY_DELTA=0`` switch, an unknown epoch, a map
        overflow, a releasing session, or a dirty set wide enough that the
        whole-tensor compare wins) the whole tensors are compared.  Both are
        exact.  The ``dirty`` note records which ran."""
        led = getattr(ssn.nodes, "ledger", None)
        if led is None:
            return False
        r = int(self._scale.shape[0])
        if led.r < r:
            led.widen(r)
        order = led.sorted_rows()
        if len(order) != len(self.node_names):
            return False  # the key pins the node count
        scale = self._scale
        evidence = {"mode": "full", "dirty_nodes": -1, "rows_scattered": -1}
        dirty = self._dirty_node_set(ssn)
        handled = False
        node_changed = False
        if dirty is not None:
            evidence.update(mode="sparse", dirty_nodes=len(dirty), rows_scattered=0)
            handled, node_changed = self._refresh_nodes_sparse(led, dirty, r, evidence)
        if not handled:
            evidence.update(mode="full", dirty_nodes=-1, rows_scattered=-1)
            idle = led.idle[order][:, :r]
            releasing = led.releasing[order][:, :r]
            task_count = led.task_count[order].astype(np.int32)
            if bool(np.any(releasing)) != self.has_releasing:
                return False
            nb = self.n_bucket
            node_changed = self._refresh_buffer(
                "idle", pad_rows(scale_columns(idle, scale), nb))
            node_changed |= self._refresh_buffer(
                "releasing", pad_rows(scale_columns(releasing, scale), nb))
            node_changed |= self._refresh_buffer("task_count", pad_rows(task_count, nb))
            # The host snapshot keeps serving readers after the build.
            self.st.nodes.idle = idle
            self.st.nodes.releasing = releasing
            self.st.nodes.used = led.used[order][:, :r]
            self.st.nodes.task_count = task_count
        phases.note("dirty", evidence)
        self._refresh_epoch = getattr(ssn, "dirty_epoch", -1)

        queue_changed = False
        if self.queue_comparators or self.overused_gate:
            builder = ssn.device_queue_fair.get("proportion")
            if builder is None:
                return False
            # Allocated-at-open moves with the whole cluster, not only with
            # this engine's jobs: always re-solve ([Q, R] rows).
            fair = builder(self.queue_uids)
            self._qfair = dict(fair.get("qfair", {}))
            qd_old, qa_old = self._host_queue_fair
            qd = np.zeros_like(qd_old)
            qa = np.zeros_like(qa_old)
            qd[:] = scale_columns(fair["deserved"], scale)
            qa[:] = scale_columns(fair["allocated"], scale)
            if not (np.array_equal(qd, qd_old) and np.array_equal(qa, qa_old)):
                self._host_queue_fair = (qd, qa)
                queue_changed = True
        if node_changed or queue_changed:
            self._rewire_args(node_changed, queue_changed)
        return True

    # Dirty sets wider than nodes / RATIO take the whole-tensor compare.
    SPARSE_DIRTY_RATIO = 8

    def _dirty_node_set(self, ssn):
        """Node names dirtied after this engine's last refresh, or ``None``
        where the sparse path must not run: the switch off, a releasing
        session, an unknown epoch, a map overflow, or a dirty set wider than
        nodes / ``SPARSE_DIRTY_RATIO``."""
        if not _dirty_delta_enabled() or self.has_releasing:
            return None
        if self._refresh_epoch < 0 or getattr(ssn, "dirty_epoch", -1) < 0:
            return None
        fn = getattr(getattr(ssn, "cache", None), "dirty_nodes_since", None)
        if fn is None:
            return None
        dirty = fn(self._refresh_epoch)
        if dirty is None or len(dirty) * self.SPARSE_DIRTY_RATIO > len(self.node_names):
            return None
        return dirty

    def _refresh_nodes_sparse(self, led, dirty, r: int, evidence: dict):
        """Refresh exactly the dirtied node rows.  Returns ``(handled,
        node_changed)``; ``handled`` False sends the caller to the
        whole-tensor path (releasing capacity appeared: only that path's
        check may decide the rebuild)."""
        if not dirty:
            return True, False
        index = self._node_index
        if index is None:
            index = self._node_index = {name: i for i, name in enumerate(self.node_names)}
        eng_rows, led_rows = [], []
        for name in sorted(dirty):  # deterministic write order
            i = index.get(name)
            row = led.row_of.get(name)
            if i is None or row is None:
                # A node added or removed around this snapshot moved the node
                # generation and with it the layout token: the caller
                # rebuilds this cycle or the next.
                continue
            eng_rows.append(i)
            led_rows.append(row)
        if not eng_rows:
            return True, False
        eng = np.asarray(eng_rows, dtype=np.int64)
        rows = np.asarray(led_rows, dtype=np.int64)
        releasing = led.releasing[rows][:, :r]
        if np.any(releasing):
            return False, False
        scale = self._scale
        idle = led.idle[rows][:, :r]
        task_count = led.task_count[rows].astype(np.int32)
        changed = self._refresh_rows("idle", eng, scale_columns(idle, scale), evidence)
        changed |= self._refresh_rows(
            "releasing", eng, scale_columns(releasing, scale), evidence)
        changed |= self._refresh_rows("task_count", eng, task_count, evidence)
        # Engine row i is sorted position i on both sides.
        self.st.nodes.idle[eng] = idle
        self.st.nodes.releasing[eng] = releasing
        self.st.nodes.used[eng] = led.used[rows][:, :r]
        self.st.nodes.task_count[eng] = task_count
        return True, changed

    def _refresh_rows(self, name: str, eng_rows: np.ndarray, new_vals, evidence: dict) -> bool:
        """Sparse twin of ``_refresh_buffer``: compare only the dirty rows
        and write the changed ones, into the host copy in place and into the
        device twin."""
        host = self._host_dyn[name]
        new_vals = np.asarray(new_vals, dtype=host.dtype)
        diff = host[eng_rows] != new_vals
        changed = np.nonzero(diff.any(axis=1) if new_vals.ndim == 2 else diff)[0]
        if changed.shape[0] == 0:
            return False
        rows = eng_rows[changed]
        host[rows] = new_vals[changed]
        evidence["rows_scattered"] += int(rows.shape[0])
        self._write_device_rows(name, rows)
        return True

    def _refresh_buffer(self, name: str, new_host: np.ndarray) -> bool:
        """Bring one dynamic node tensor up to ``new_host``.  Unchanged
        content keeps everything (the steady cycle); otherwise the changed
        rows are written into the device twin."""
        old_host = self._host_dyn[name]
        if np.array_equal(old_host, new_host):
            return False
        diff = new_host != old_host
        rows = np.nonzero(diff.any(axis=1) if new_host.ndim == 2 else diff)[0]
        self._host_dyn[name] = new_host
        self._write_device_rows(name, rows)
        return True

    def _write_device_rows(self, name: str, rows: np.ndarray) -> None:
        """Write host rows ``rows`` of ``name`` into its device twin (the
        mega kernel's; the loop engines read the host copy).  In place only
        into a twin the engine owns, and only for a few rows; a shared
        transfer-cache resident, or wide churn, gets a new copy of the whole
        host tensor, which the engine owns from then on.  The copy is
        synchronous and the in-place write is ordered on the stream after
        the engine's previous launch, which reads the twin."""
        if self._dyn_dev is None:
            return
        host = self._host_dyn[name]
        dev = self._dyn_dev[name]
        if self._dyn_owned[name] and rows.shape[0] * 4 <= host.shape[0]:
            idx = torch.as_tensor(rows, dtype=torch.int64, device=dev.device)
            vals = torch.from_numpy(np.ascontiguousarray(host[rows])).to(dev.device)
            dev.index_copy_(0, idx, vals)
        else:
            self._dyn_dev[name] = torch.from_numpy(host.copy()).to(dev.device)
            self._dyn_owned[name] = True

    def _rewire_args(self, node_changed: bool, queue_changed: bool) -> None:
        """Rebuild what derives from the refreshed rows in every operand set
        this engine stages: the loop's node and queue operands (and the
        ladder's tables), K2's node ledgers, queue lanes and ladder
        tables."""
        r = int(self._scale.shape[0])
        qd, qa = self._host_queue_fair
        if queue_changed:
            parts = list(self._args_parts)
            parts[11], parts[12] = qd, qa
            self._args_parts = tuple(parts)
            if self.qfair_ladder:
                self._ladder_host = self._ladder_tables(qd, qa)
        if self._args is not None:
            a = list(self._args)
            if node_changed:
                a[0] = np.ascontiguousarray(self._host_dyn["idle"], dtype=np.float32)
                a[1] = np.ascontiguousarray(self._host_dyn["releasing"], dtype=np.float32)
                a[2] = self._host_dyn["task_count"]
            if queue_changed:
                a[21], a[22] = self._padded_queue_rows(qd, qa)
                if self.qfair_ladder:
                    qf_share, qf_over = self._ladder_host
                    a[26] = np.ascontiguousarray(qf_share, dtype=np.float32)
                    a[27] = np.ascontiguousarray(qf_over, dtype=bool)
            self._args = tuple(a)
        if self.use_mega:
            m = list(self._mega_args)
            if node_changed:
                m[0], m[2] = _mk.build_node_ledgers(
                    self._dyn_dev["idle"], self._dyn_dev["task_count"],
                    self._dyn_dev["releasing"], self.n_bucket, r, self.has_releasing)
            if queue_changed and self._mega_qpack is not None:
                jq, j_pad, jb = self._mega_qpack
                jq_des = np.zeros((8, j_pad), dtype=np.float32)
                jq_des[:r, :jb] = np.asarray(qd, dtype=np.float32)[jq].T
                jq_alloc0 = np.zeros((8, j_pad), dtype=np.float32)
                jq_alloc0[:r, :jb] = np.asarray(qa, dtype=np.float32)[jq].T
                m[21] = _to_device(jq_des, device=self.device)
                m[22] = _to_device(jq_alloc0, device=self.device)
                if self._mega_kw.get("qfair_ladder"):
                    qf_share, qf_over = self._pack_mega_ladder()
                    m[23] = _to_device(qf_share, device=self.device)
                    m[24] = _to_device(qf_over, device=self.device)
            self._mega_args = tuple(m)

    def _padded_queue_rows(self, queue_deserved, queue_alloc):
        """The loop's float32 [qb, R] deserved and allocated-at-open rows."""
        qb = bucket(max(len(self.queue_uids), 1))
        q_n = queue_deserved.shape[0]
        q_des = np.zeros((qb, queue_deserved.shape[1]), dtype=np.float32)
        q_des[:q_n] = queue_deserved
        q_alloc = np.zeros_like(q_des)
        q_alloc[:q_n] = queue_alloc
        return q_des, q_alloc

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
            # Static [T, N] tensors (bool mask + f32 score = 5 bytes an
            # element) fuse while they fit the limit; past it the per-pop
            # engine (ops/allocator.py) reads the rows a pop at a time.
            # SCHEDULER_TORCH_FUSED_STATIC_LIMIT is in bytes.
            n_bucket = bucket(max(len(ssn.nodes), 1))
            sized = ssn.jobs.values() if jobs is None else jobs
            pending = sum(job.pending_eligible_count() for job in sized)
            t_bucket = bucket(max(pending, 1))
            if 5 * t_bucket * n_bucket > fused_static_limit():
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

    @property
    def engine(self) -> str:
        """``"mega"`` (one launch of the whole loop), ``"step"`` (the loop
        with one placement-step launch a step), ``"xla"`` (the loop's XLA
        step arm: tensor operations on the device each step), ``"lp"`` (the
        LP relaxation and its repair) or ``"none"`` (nothing pending)."""
        if self.flat_count == 0:
            return "none"
        if self.use_lp:
            return "lp"
        if self.use_mega:
            return "mega"
        return "step" if self.step_kernel else "xla"

    @property
    def args(self) -> tuple:
        """The loop's operands (``FUSED_OPERAND_NAMES``), staged at first use
        as the JAX engine's ``args`` are (``scheduler_tpu/ops/fused.py:2772-2820``):
        the ``HOST_OPERANDS`` as numpy arrays, the rest on the engine's
        device.  Static rows come one a static signature ([S, N], with
        ``sig_of_task`` naming each task's row), as the mega kernel's
        static-row mode stages them, never [T, N]."""
        if self._args is None:
            (scale, node_gate, total, offsets, nums, deficits, gang_order, priorities,
             tiebreak, queues_idx, alloc_init, queue_deserved, queue_alloc, run_host,
             static_sids, static_mask_dev, static_score_dev, mins_f32) = self._args_parts
            dev = self.device
            st, tb, t = self.st, self._t_bucket, self.flat_count
            state = self._node_state(scale)

            def to_dev(a, dtype=None):
                return _to_device(a, dtype, device=dev)

            def f32(a):
                return np.ascontiguousarray(a, dtype=np.float32)

            sig_host = np.zeros(tb, dtype=np.int32)
            if static_mask_dev is None:
                static_mask_dev = torch.ones((1, 1), dtype=torch.bool, device=dev)
                static_score_dev = torch.zeros((1, 1), dtype=torch.float32, device=dev)
            elif static_sids is not None:
                # One row a static signature, gathered from its first task's.
                _, first_rows = np.unique(static_sids, return_index=True)
                rep = torch.as_tensor(first_rows.astype(np.int64), device=dev)
                static_mask_dev, static_score_dev = static_mask_dev[rep], static_score_dev[rep]
                sig_host[:t] = static_sids
            qb = bucket(max(len(self.queue_uids), 1))
            q_n = queue_deserved.shape[0]
            queue_rank = np.arange(qb, dtype=np.int32)
            queue_has = np.zeros(qb, dtype=bool)
            queue_has[:q_n] = True
            q_des, q_alloc = self._padded_queue_rows(queue_deserved, queue_alloc)
            if self._ladder_host is not None:
                qf_share, qf_over = self._ladder_host
            else:
                qf_share = np.zeros((1, 1), dtype=np.float32)
                qf_over = np.zeros((1, 1), dtype=bool)
            self._args = (
                f32(state["idle"]),
                f32(state["releasing"]),
                state["task_count"],
                to_dev(state["allocatable"], np.float32),
                to_dev(state["pods_limit"]),
                to_dev(node_gate),
                to_dev(mins_f32),
                to_dev(pad_rows(scale_columns(st.tasks.init_resreq[:t], scale), tb), np.float32),
                to_dev(pad_rows(scale_columns(st.tasks.resreq[:t], scale), tb), np.float32),
                static_mask_dev,
                static_score_dev,
                offsets,
                nums,
                deficits,
                gang_order,
                priorities,
                tiebreak,
                queues_idx,
                f32(scale_columns(alloc_init, scale)),
                queue_rank,
                queue_has,
                q_des,
                q_alloc,
                f32(scale_columns(total[None, :], scale)[0]),
                run_host,
                sig_host,
                f32(qf_share),
                np.ascontiguousarray(qf_over, dtype=bool),
            )
            if self._mesh is not None:
                from scheduler_tpu_torch.ops.mesh import shard_fused_args

                self._args = shard_fused_args(self._mesh, self._args)
        return self._args

    def _allocate_kw(self) -> dict:
        """The loop's static arguments (the JAX ``_allocate_kw``, but the
        ``window`` unrolling and the mesh)."""
        return dict(
            comparators=self.comparators,
            queue_comparators=self.queue_comparators,
            overused_gate=self.overused_gate,
            use_static=self.use_static,
            n_queues=len(self.queue_uids),
            weights=self.weights,
            enforce_pod_count=self.enforce_pod_count,
            batch_runs=self.batch_runs,
            sorted_jobs=True,
            has_releasing=self.has_releasing,
            step_kernel=self.step_kernel,
            queue_delta=self.queue_delta,
            sig_compress=self._sig_compress,
            qfair_ladder=self.qfair_ladder,
            mesh=self._mesh,
        )

    def dispatch(self) -> None:
        """Start the engine: the mega kernel is enqueued on the current
        stream WITHOUT blocking (``readback`` collects it); the loop runs to
        its end here, since every step waits for its selection.  A no-op
        when a run is in flight or nothing is pending."""
        if self._dev is not None or self.flat_count == 0:
            return
        from scheduler_tpu_torch.utils import shardcheck

        if self.device.type == "cuda":
            # Device time on the device clock, read at readback.
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        if self.use_lp:
            self._dispatch_lp()
        elif self.use_mega:
            # Whole-loop kernel operands run replicated on a mesh by design:
            # every position checks as replicated.
            shardcheck.check_dispatch(self._mesh, self._mega_args, families=())
            # The session's queue count bounds the queue indices: the launch
            # need not read them back from the device.
            self._dev, self._dev_stats = _mk.mega_allocate(
                *self._mega_args, n_queues=len(self.queue_uids), **self._mega_kw)
        else:
            # SCHEDULER_TORCH_SHARDCHECK=1: each operand's placement against
            # its registry family (utils/shardcheck.py).
            shardcheck.check_dispatch(self._mesh, self.args)
            self._dev, self._dev_stats = fused_allocate(*self.args, **self._allocate_kw())
        if self._events is not None:
            self._events[1].record()

    def _lp_kw(self) -> dict:
        """The relaxation's static arguments (the JAX ``_lp_kw`` but the mesh)."""
        from scheduler_tpu_torch.ops import lp_place

        return dict(iters=lp_place.lp_iters(), tau=lp_place.lp_tau(), tol=lp_place.lp_tol(),
                    weights=self.weights, enforce_pod_count=self.enforce_pod_count,
                    use_static=self.use_static, mesh=self._lp_mesh)

    def _lp_class_dev(self):
        """The [S]-class LP operands on the engine's device (request rows,
        init request rows and the f32 task count a class), staged once a
        build: the class table is layout-derived, so a hit keeps them."""
        if self._lp_sig_dev is None:
            self._lp_sig_dev = tuple(_to_device(a, np.float32, device=self.device)
                                     for a in self._lp_sig_host)
        return self._lp_sig_dev

    def _lp_operands(self):
        """The relaxation's operands from the loop's staged ``args``
        (``scheduler_tpu/ops/fused.py:2966-2988``): the open node state, the
        static rows and the request rows of the tasks, or of the classes
        with their counts."""
        args = self.args
        dev = self._mesh.first if self._mesh is not None else self.device
        idle = torch.as_tensor(args[0], device=dev)
        task_count = torch.as_tensor(args[2], device=dev)
        smask, sscore = self._lp_static if self._lp_static is not None else (None, None)
        if self.sig_compress:
            init_c, req_c, count_c = self._lp_class_dev()
            rows = (init_c, req_c, count_c)
        else:
            rows = (args[7], args[8], None)
        return (idle, args[3], task_count, args[4], args[5], smask, sscore, args[6]) + rows

    def _dispatch_lp(self) -> None:
        """The LP flavor's run (``scheduler_tpu/ops/fused.py:2949-3020``):
        the relaxation (``lp_place.lp_relax``: ``csrc/lp_relax.cu`` on CUDA
        tensors), then the repair, the loop with the marginals as its static
        score and the open-state feasibility as its static mask, zero
        dynamic weights, no releasing arm and no step kernel, so it takes
        the XLA step arm, with the session's own job and queue chain.  Rows
        are classes under signature compression (the loop reads them
        through ``sig_of_task``), tasks otherwise.  The wall split is
        ``lp_phase`` (``lp_iterate``: the relaxation up to its evidence on
        the host; ``lp_repair``: the loop), also recorded as phases."""
        import time as _time

        from scheduler_tpu_torch.ops import lp_place

        args = self.args
        t0 = _time.perf_counter()
        ev = None
        if self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        marginals, feas, pref, lp_raw = lp_place.lp_relax(*self._lp_operands(),
                                                          **self._lp_kw())
        if ev is not None:
            ev[1].record()
        self._lp_stats_host = (pref.cpu().numpy().astype(np.int32), lp_raw.cpu().numpy())
        if ev is not None:
            self.lp_ms = ev[0].elapsed_time(ev[1])
        t1 = _time.perf_counter()
        a = list(args)
        a[FUSED_OPERAND_NAMES.index("static_mask")] = feas
        a[FUSED_OPERAND_NAMES.index("static_score")] = marginals
        if self.sig_compress:
            sig_lp = np.zeros(self._t_bucket, dtype=np.int32)
            sig_lp[:self.flat_count] = self.sig_of_task
            a[FUSED_OPERAND_NAMES.index("sig_of_task")] = sig_lp
        self._dev, self._dev_stats = fused_allocate(
            *a,
            comparators=self.comparators,
            queue_comparators=self.queue_comparators,
            overused_gate=self.overused_gate,
            use_static=True,
            n_queues=len(self.queue_uids),
            weights=(0.0, 0.0, 0.0),
            enforce_pod_count=self.enforce_pod_count,
            batch_runs=self.batch_runs,
            sorted_jobs=True,
            has_releasing=False,
            step_kernel=False,
            queue_delta=self.queue_delta,
            sig_compress=self.sig_compress,
            qfair_ladder=self.qfair_ladder,
            mesh=self._mesh,
        )
        t2 = _time.perf_counter()
        self.lp_phase = {"lp_iterate": t1 - t0, "lp_repair": t2 - t1}
        if phases.active():
            phases.add("lp_iterate", t1 - t0)
            phases.add("lp_repair", t2 - t1)

    def readback(self) -> np.ndarray:
        """Blocking collect of the dispatched run's placement codes
        (dispatching first when nothing is in flight)."""
        if self.flat_count == 0:
            self._encoded = np.zeros(0, dtype=np.int32)
            self._stats_raw = None
            return self._encoded
        if self._dev is None:
            self.dispatch()
        dev, self._dev = self._dev, None
        stats, self._dev_stats = self._dev_stats, None
        from scheduler_tpu_torch.utils import shardcheck

        # Codes and evidence are per-task values: whole, never sharded.
        shardcheck.check_result(self._mesh, dev)
        shardcheck.check_result(self._mesh, stats, where="readback.stats")
        self._encoded = dev.cpu().numpy().astype(np.int32, copy=False)
        self._stats_raw = stats if isinstance(stats, dict) else stats.cpu().numpy()
        if self._events is not None:
            start, stop = self._events
            self._events = None
            # The codes' copy need not wait for the stream (the step loop's
            # results come through host memory): wait for the event itself.
            stop.synchronize()
            if self.use_mega:
                self.kernel_ms = start.elapsed_time(stop)
            else:
                # The loop: the arm's summed device time (K1's launches, or
                # the XLA arm's steps), and the whole loop.
                self.loop_ms = start.elapsed_time(stop)
                self.kernel_ms = self._stats_raw["k1_ms"] if self.step_kernel \
                    else self._stats_raw["xla_ms"]
        return self._encoded

    def _codes(self) -> np.ndarray:
        encoded = self._encoded
        if encoded is None:
            encoded = self.readback()
        return encoded

    def run_stats(self) -> dict:
        """Evidence of the last run: the engine, cohorts seen by the build,
        loop steps, tasks per step, chunk placements (mega) or the loop's
        time and chain selections (step, xla).  The queue chain's counters
        are the kernel's (a refresh a placement) or the loop's (a refresh
        a pop).  ``kernel_ms`` is the device time from CUDA events: the one
        mega launch, the placement-step launches summed (also ``k1_ms``) or
        the XLA arm's steps summed (also ``xla_ms``); ``loop_ms`` is the
        whole loop, host steps included, from CUDA events around it."""
        out = {
            "engine": self.engine,
            "cohorts": self.cohort_count,
            "cohort_chunks": self.cohort_effective if self.use_mega else 1,
        }
        if self.queue_comparators or self.overused_gate:
            # Queue-chain evidence (the kernel's counters below): the delta or
            # the full-recompute chain, and proportion's water-fill block with
            # the ladder's engagement (its size and lookups) or why it did
            # not engage.
            out["queue_chain"] = {"queues": len(self.queue_uids),
                                  "mode": "delta" if self.queue_delta else "full"}
            qf = dict(self._qfair)
            qf["engaged"] = self.qfair_ladder
            if self.qfair_ladder:
                qf["rungs"] = int(self._ladder_host[0].shape[1])
                qf["classes"] = len(self.queue_uids)
                qf["ladder_lookups"] = 0
            elif self.qfair_reason:
                qf["reason"] = self.qfair_reason
            out["qfair"] = qf
        enc = self._encoded
        if enc is not None:
            codes = enc[: self.flat_count]
            out["placed"] = int(((codes >= 0) | (codes <= _PIPE_BASE)).sum())
        if self.use_lp:
            out["lp"] = self._lp_block(enc)
        if self.sig_mode != "off" and self.flat_count > 0:
            out["sig"] = self._sig_block()
        raw = self._stats_raw
        if isinstance(raw, dict):
            out["steps"] = raw["steps"]
            out["chain_selects"] = raw["chain_selects"]
            for key in ("k1_ms", "xla_ms", "xla_host_ms"):
                if raw[key] is not None:
                    out[key] = raw[key]
            if "queue_chain" in out:
                out["queue_chain"]["delta_updates"] = raw["delta_updates"]
                out["queue_chain"]["full_recomputes"] = raw["full_recomputes"]
                if self.qfair_ladder:
                    out["qfair"]["ladder_lookups"] = raw["ladder_lookups"]
        elif raw is not None:
            steps = int(raw[STATS.STEPS])
            out["steps"] = steps
            out["cohort_steps"] = int(raw[STATS.COHORT_STEPS])
            out["chunk_placed"] = int(raw[STATS.CHUNK_PLACED])
            out["fallback_steps"] = steps - out["cohort_steps"]
            if "queue_chain" in out:
                out["queue_chain"]["delta_updates"] = int(raw[STATS.QDELTA_UPDATES])
                out["queue_chain"]["full_recomputes"] = int(raw[STATS.QFULL_RECOMPUTES])
                if self.qfair_ladder:
                    out["qfair"]["ladder_lookups"] = int(raw[STATS.QFAIR_LOOKUPS])
        if out.get("steps") and "placed" in out:
            out["tasks_per_step"] = round(out["placed"] / out["steps"], 2)
        if self.kernel_ms is not None:
            out["kernel_ms"] = self.kernel_ms
        if self.loop_ms is not None:
            out["loop_ms"] = self.loop_ms
        if self.lp_ms is not None:
            out["lp_ms"] = self.lp_ms
        if self._mesh is not None:
            from scheduler_tpu_torch.ops.mesh import mesh_topology

            # The topology, whether the node operands split (a bucket that
            # does not divide the mesh stays whole) and the loop's shards.
            mesh = mesh_topology(self._mesh)
            mesh["sharded"] = self.n_bucket % self._mesh.size == 0
            if isinstance(raw, dict):
                mesh["loop_shards"] = raw.get("shards", 1)
            out["mesh"] = mesh
        return out

    def _lp_block(self, enc) -> dict:
        """The LP quality block (``scheduler_tpu/ops/fused.py:3355-3383``):
        the temperature, the relaxation's evidence and the repaired
        solution's quality (``lp_place.lp_quality``), the class preference
        expanded to tasks through ``sig_of_task``."""
        from scheduler_tpu_torch.ops import lp_place

        lp: dict = {"tau": lp_place.lp_tau()}
        if self._lp_stats_host is not None:
            pref, lp_raw = self._lp_stats_host
            lp.update(lp_place.lp_stats_dict(lp_raw))
            if enc is not None:
                t = self.flat_count
                pref_t = pref[self.sig_of_task] if self.sig_compress else pref[:t]
                lp.update(lp_place.lp_quality(
                    enc[:t], pref_t, self.st.tasks.resreq[:t], self.st.nodes.idle,
                    self.st.tasks.job_idx[:t], self.st.nodes.allocatable))
        return lp

    def _sig_block(self) -> dict:
        """The signature-class evidence (``scheduler_tpu/ops/fused.py:
        3384-3400``): classes, tasks, the compression factor and the bytes
        the class rows save against the [T, N] rows (16 a cell under LP, 5
        with static rows), or why classes did not engage."""
        from scheduler_tpu_torch.ops import sig_compress as _sc

        if not self.sig_compress:
            sig = {"engaged": False}
            if self.sig_reason:
                sig["reason"] = self.sig_reason
            return sig
        per_elem = 16 if self.use_lp else (5 if self.use_static else 0)
        saved = max(self._t_bucket - self._sig_bucket, 0) * self.n_bucket * per_elem
        sig = _sc.sig_stats(self.sig_classes, self.flat_count, saved)
        sig["engaged"] = True
        return sig

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
