"""The whole greedy allocate action as ONE CUDA kernel launch.

This replaces ``scheduler_tpu/ops/megakernel.py::mega_allocate`` (a Pallas
TPU kernel) in two job-selection modes, each with or without its STATIC-ROW
mode (``use_static``: the per-signature mask and score rows
``smask``/``sscore`` that a task reaches through ``msig``, staged when the
predicates or nodeorder plugin is on) and with or without RELEASING
CAPACITY (``has_releasing``):

* CURSOR MODE — one queue, jobs laid out in init-key order, a job selected
  by the cursor while no job is dirty;
* MULTI-QUEUE MODE (``multi_queue``) — at every pop the queue of least
  proportion share among those not overused (``queue_proportion``,
  ``overused_gate``), then the job chain within it.  Each placement grows
  its queue's allocated; the queue's share and overused flag then follow
  one of three chains, all bit for bit the same values: the DELTA chain
  (``queue_delta``, the default) re-derives that queue's share and flag per
  placement; the FULL-RECOMPUTE chain (``queue_delta=False``) re-derives
  every queue's at each pop; the QFAIR LADDER (``qfair_ladder``, with the
  delta chain) reads them from the rung tables ``qf_share`` / ``qf_over``
  at the queue's placement count (``ops/qfair.py::build_ladder``);
* RELEASING CAPACITY (``has_releasing``) — a second node ledger, ``rel0``,
  holds what evicted pods free once they terminate.  A task fits a node on
  its idle OR its releasing capacity (Volcano's allocate,
  ``allocate.go:80-93``); the score reads idle alone; the winner's idle fit
  decides: an ALLOCATION debits idle, else the task is PIPELINED onto the
  releasing capacity (one copy, code ``-3 - node``, debiting the releasing
  ledger).  Both raise the node's task count and the job's drf row, and in
  multi-queue mode its queue's allocated (proportion's allocate handler
  fires on pipeline too).  Cohort chunks are off (``cohort = 1``).

MESH MODE (``mesh``, an ``ops/mesh.py`` NodeMesh) is the JAX kernel's
replicated mode: one launch with every operand whole on the mesh's first
device, the same plan and the same machine code.  The kernel source is
``csrc/mega_allocate.cu``; it is built with the port's other kernels at
first use (``ops/cuda_build.py``) and bound through a plain C entry point
with ``ctypes``.

Three functions carry the port:

* ``mega_allocate`` — the wrapper.  CUDA tensors launch the kernel on the
  current stream (or raise); CPU tensors run ``mega_allocate_reference``.
  Each launch adds one to ``launches``.
* ``mega_allocate_reference`` — the plain PyTorch version: a Python loop
  over steps, node-wide work as tensor ops, that follows the kernel's
  float32 arithmetic operation by operation.  Its integer-valued counters
  (tasks consumed / allocated per job, loop scalars) are held as Python
  numbers, which represent those float32 values exactly.
* the host packers (``request_signature_ids``, ``pack_lane_i32``,
  ``pack_task_table_i32``, ``build_node_ledgers``) that stage the operands.

Operands and result encoding follow the JAX kernel exactly (26 operands,
the releasing, queue, ladder and static ones outside their modes as
dummies): codes are >= 0 node, -1 unplaced, -2 failed (first infeasible
task of its pop), <= -3 pipelined onto node ``-3 - code``; the second output
holds the 8 ``STATS`` counters.

Where the kernel's time goes on the card: the loop is a dependent chain of
``STATS.STEPS`` steps of one or more placement chunks, and each chunk is a
fit + score + masked argmax over every node and a batch grid on the winner:
per-chunk latency bounds it (memory round trips, barriers, reductions), not
bytes or FLOPs.  The kernel is one thread-block cluster, persistent for the
whole action, that keeps the node ledger in its CTAs' shared memory from the
first chunk to the last; once a chunk every CTA stores its best pairs and
winner column into every CTA (distributed shared memory, completing on the
receiver's mbarrier) and merges the C it receives, with no cluster barrier
in the loop (the design is in the source note).  ``mega_plan`` is its
launch plan: the cluster size, the node slices and what sits in shared
memory; a shape that the mega gate admits and the plan cannot launch raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.layout import (
    JOB_SCRATCH as JROW,
    JOB_STATE,
    NODE_SCRATCH as NROW,
    SIG_REQ,
    STATS,
    STATS_WIDTH,
    job_scratch_rows,
    node_scratch_rows,
)

# Result encoding — MUST match ops/fused.py.
UNPLACED = -1
FAILED = -2
PIPE_BASE = -3  # pipelined code = PIPE_BASE - node
HALT = -100
MAX_BATCH = 128

_BIG_I32 = 2**31 - 1

# Operand order of ``mega_allocate`` (the JAX kernel's order).
OPERAND_NAMES = (
    "ns0", "alloc_t", "rel0", "gate", "plim", "sig_req", "task_sig",
    "run_len", "job_off", "job_num", "job_deficit", "job_gang", "job_prio",
    "job_tb", "js_drf0", "drf_safe", "drf_mask", "msig", "smask", "sscore",
    "jqueue", "jq_des", "jq_alloc0", "qf_share", "qf_over", "misc",
)

_COMPARATOR_CODES = {"priority": 0, "gang": 1, "drf": 2}

# Launches of the CUDA kernel (the CPU path never counts).
launches = 0

# An int64 CUDA tensor of PHASE_WORDS that a kernel built with
# -DMEGA_PHASE_CLOCKS fills with its per-phase clock sums
# (scripts/k2_phases.py); None in normal use.
phase_clocks = None
PHASE_WORDS = 12


def task_table_rows(t_pad: int) -> int:
    """Rows of the windowed [rows, 128] cohort-table layout for a t_pad-long
    per-task column (task_sig / run_len / msig)."""
    return max(1, -(-t_pad // 128))


def mega_supported(
    *,
    has_releasing: bool,
    use_static: bool,
    score_bound: bool,
    cursor_mode: bool,
    r_dim: int,
    n: int,
    n_sigs: int,
    comparators: Tuple[str, ...],
    n_static_sigs: int = 0,
    multi_queue: bool = False,
) -> bool:
    """The JAX kernel's admission gate, mirrored so that the port admits
    exactly the sessions the JAX engine runs through its mega kernel (the
    caller then raises for the modes this package does not carry)."""
    del has_releasing, score_bound
    if use_static:
        s_pad = max(8, -(-n_static_sigs // 8) * 8)
        if not (0 < n_static_sigs and s_pad * n * 8 <= 4 * 1024 * 1024):
            return False
    return (
        (cursor_mode or multi_queue)
        and r_dim <= 8
        and n <= 32768
        and 0 < n_sigs <= 4096
        and set(comparators) <= {"priority", "gang", "drf"}
    )


def _check_mode(multi_queue, qfair_ladder, mesh, queue_delta=True,
                queue_proportion=False, overused_gate=False, operands=()) -> None:
    """Cursor mode and multi-queue mode in its three queue chains (each with
    or without static rows and releasing capacity) are ported, and each of
    them in mesh mode: the JAX kernel runs replicated on a mesh, every in-
    and out-spec ``P()`` (``scheduler_tpu/ops/megakernel.py:994-1015``), so
    one controller launches it once with every operand whole on the mesh's
    first device (``operands``, where given, must lie there).  The qfair
    ladder refines the delta chain: it needs multi-queue mode with
    ``queue_delta`` and a queue chain to maintain."""
    if mesh is not None:
        first = getattr(mesh, "first", None)
        if first is None:
            raise TypeError(f"mega_allocate: mesh must be an ops.mesh.NodeMesh, got {mesh!r}")
        for i, a in enumerate(operands):
            if a.device != first:
                raise ValueError(f"mega_allocate: in mesh mode operand {OPERAND_NAMES[i]} must "
                                 f"lie whole on the mesh's first device {first}, not {a.device}")
    if qfair_ladder and not (multi_queue and queue_delta
                             and (queue_proportion or overused_gate)):
        raise ValueError("mega_allocate: the qfair ladder needs multi-queue mode with the "
                         "delta chain (queue_delta and a queue chain)")


def queue_share_overused(deserved, allocated, mins, r_dim: int):
    """Proportion's share and overused flag, as the JAX kernels derive them
    (``scheduler_tpu/ops/pallas_kernels.py:81-115``): ``deserved`` and
    ``allocated`` are float32 tensors indexed by dim first (rows [r_dim, J]
    or one queue's [r_dim]).  Dims fold in ascending order.

      share    = max over dims of allocated / deserved, with 0/0 -> 0 and,
                 for cpu and memory (dims 0 and 1), x/0 -> 1; other dims
                 with deserved 0 contribute 0
      overused = deserved - allocated < min on every dim"""
    share = over = None
    for r in range(r_dim):
        d, a = deserved[r], allocated[r]
        pos = d > 0.0
        fr = torch.where(pos, a / torch.where(pos, d, 1.0), 0.0)
        if r < 2:
            fr = torch.where(~pos & (a > 0.0), 1.0, fr)
        share = fr if share is None else torch.maximum(share, fr)
        le = (d - a) < mins[r]
        over = le if over is None else over & le
    return share, over


# -- bind -------------------------------------------------------------------------

class _MegaArgs(ctypes.Structure):
    """Mirror of ``struct MegaArgs`` in ``csrc/mega_allocate.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "ns0", "alloc_t", "gate", "plim", "sig_req", "task_sig", "run_len",
            "job_off", "job_num", "job_def", "job_gang", "job_prio", "job_tb",
            "js_drf0", "drf_safe", "drf_mask", "misc", "msig", "smask", "sscore",
            "jqueue", "jq_des", "jq_alloc0", "qf_share", "qf_over", "qlanes", "out",
            "stats", "js_global", "phase_clocks",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "nb", "s_pad", "t_rows", "t_cap", "j_pad", "r_dim",
            "cpu_idx", "mem_idx", "enforce_pod_count", "cross_batch",
            "batch_runs", "score_bound", "cohort", "n_comp",
            "use_static", "static_rows", "multi_queue", "queue_proportion",
            "overused_gate", "n_queues", "queue_delta", "qfair_ladder", "qf_rows",
            "ctas", "slice", "smem_bytes",
            "off_queue", "off_js", "off_sig", "off_job", "off_static",
        )
    ] + [
        ("comp", ctypes.c_int * 4),
        ("w_lr", ctypes.c_float),
        ("w_bal", ctypes.c_float),
        ("w_bp", ctypes.c_float),
        ("mins", ctypes.c_float * 8),
        ("rel0", ctypes.c_void_p),
        ("has_releasing", ctypes.c_int),
    ]


def _entry():
    """The kernel's C entry point from the port's CUDA library."""
    fn = cuda_build.load().mega_allocate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# -- the launch plan --------------------------------------------------------------

# Shared memory one CTA may hold on the H100 (227 KB), and the part of it the
# kernel's static arrays take (every CTA's exchange slots, warp pairs,
# reduction areas; 3,504 bytes by -Xptxas -v).
SMEM_LIMIT = 232_448
_STATIC_SMEM = 4096
THREADS = 512  # a CTA (csrc/mega_allocate.cu THREADS)
_ERR_NO_CLUSTER = 10001


class MegaPlan(NamedTuple):
    """How the kernel launches for one shape: ``ctas`` CTAs of ``threads``
    in one cluster, each with room for ``slice`` nodes, ``smem_bytes`` of
    dynamic shared memory, and each region's byte offset in it (None: the
    region stays in global memory; the job ledger then takes one copy a CTA
    in global scratch).  The queue ledger of multi-queue mode is always on
    chip (None outside that mode)."""

    ctas: int
    threads: int
    slice: int
    smem_bytes: int
    off_queue: Optional[int]
    off_js: Optional[int]
    off_sig: Optional[int]
    off_job: Optional[int]
    off_static: Optional[int]

    @property
    def job_ledger_in_global(self) -> bool:
        return self.off_js is None

    def summary(self) -> dict:
        """The plan as the records of ``chip_smoke.py`` report it."""
        return {"ctas": self.ctas, "threads": self.threads, "slice": self.slice,
                "smem_bytes": self.smem_bytes,
                "on_chip": [name for name, off in (
                    ("queue_ledger", self.off_queue), ("job_ledger", self.off_js),
                    ("sig_req", self.off_sig), ("job_operands", self.off_job),
                    ("static_rows", self.off_static))
                    if off is not None]}


def _align(x: int, to: int = 16) -> int:
    return -(-x // to) * to


def node_slice_bytes(slice_: int, r_dim: int, has_releasing: bool = False) -> int:
    """A CTA's node slice: r_dim idle rows, task count, pod limit,
    allocatable cpu and memory, r_dim releasing rows with releasing
    capacity (float32) and the gate (a byte a node)."""
    rows = r_dim + 4 + (r_dim if has_releasing else 0)
    return _align(rows * slice_ * 4 + slice_)


def job_ledger_bytes(j_pad: int, r_dim: int) -> int:
    """The compact job ledger: consumed, allocated, left and r_dim drf rows."""
    return (JOB_STATE.DRF + r_dim) * j_pad * 4


def queue_ledger_bytes(n_queues: int, r_dim: int) -> int:
    """Multi-queue mode's queue ledger: each queue's best job (a selection
    key of three 64-bit words), deserved and live allocated (r_dim floats
    each), share and overused flag, placement count (the qfair ladder's),
    and the offset and a cursor of its job lanes (two ints, one more
    offset)."""
    if not n_queues:
        return 0
    words = 2 * r_dim + 3 + 2
    return _align(24 * n_queues + words * n_queues * 4 + 4)


def job_operand_lanes(n_queues: int) -> int:
    """Words a job lane of the job operands: offset, count, deficit, gang,
    priority, rank, and the queue index in multi-queue mode."""
    return 7 if n_queues else 6


def mega_plan(nb: int, r_dim: int, j_pad: int, s_pad: int, static_rows: int,
              use_static: bool, n_queues: int = 0, has_releasing: bool = False,
              mesh=None) -> MegaPlan:
    """The kernel's launch plan for a shape (``n_queues`` > 0: multi-queue
    mode; the qfair ladder's two rung tables, up to 2 x 1,024 x 128 floats,
    stay in global memory; ``has_releasing``: the node slice holds the
    releasing rows too).  C = 8 CTAs (the portable cluster size) where
    the node slice, the queue ledger and the compact job ledger fit a CTA's
    shared memory, else 16 where that brings the node slice or the job
    ledger on chip.  The queue ledger sits on chip after the node slice.
    Then each region goes
    into shared memory if it still fits, in this order: job ledger, request
    table (2 x r_dim rows), job operands (``job_operand_lanes`` words a
    lane), static rows (mask and score of the CTA's slice).  ``mesh``: the
    plan of mesh mode, which is this plan (one launch on the mesh's first
    device over the whole node ledger)."""
    del mesh
    budget = SMEM_LIMIT - _STATIC_SMEM
    queue = queue_ledger_bytes(n_queues, r_dim)

    def slice_for(ctas):
        return _align(-(-nb // ctas), 4)

    def node(ctas):
        return node_slice_bytes(slice_for(ctas), r_dim, has_releasing) + queue

    job = job_ledger_bytes(j_pad, r_dim)
    if node(8) > budget:
        ctas = 16
    elif node(8) + job <= budget or node(16) + job > budget:
        ctas = 8
    else:
        ctas = 16
    slice_ = slice_for(ctas)
    used = node(ctas)
    if used > budget:
        raise ValueError(f"mega_allocate: no launch plan for nb={nb}, r_dim={r_dim}, "
                         f"{n_queues} queues")
    off_queue = used - queue if n_queues else None
    offsets = []
    for size in (job, 2 * r_dim * s_pad * 4, job_operand_lanes(n_queues) * j_pad * 4,
                 2 * static_rows * slice_ * 4 if use_static else None):
        if size is not None and used + size <= budget:
            offsets.append(used)
            used = _align(used + size)
        else:
            offsets.append(None)
    return MegaPlan(ctas, THREADS, slice_, used, off_queue, *offsets)


def _queues_for(kw, n_queues: Optional[int]) -> int:
    """The queue ledger's size: ``n_queues`` in multi-queue mode, where it
    is required and positive; 0 in the other modes."""
    if not kw.get("multi_queue"):
        return 0
    if n_queues is None or n_queues <= 0:
        raise ValueError("mega_allocate: multi-queue mode needs n_queues, the session's "
                         "queue count")
    return int(n_queues)


def plan_for(operands, kw, n_queues: Optional[int] = None) -> MegaPlan:
    """``mega_plan`` for the kernel's 26 operands and static arguments
    (``n_queues`` as ``mega_allocate`` takes it)."""
    ops = dict(zip(OPERAND_NAMES, operands))
    return mega_plan(ops["ns0"].shape[1], kw["r_dim"], ops["job_off"].shape[1],
                     ops["sig_req"].shape[1], ops["smask"].shape[0], kw["use_static"],
                     _queues_for(kw, n_queues), bool(kw.get("has_releasing")))


def covered_nodes(gate) -> int:
    """The nodes the kernel's partition covers: [0, last gated node + 1),
    at least one (nodes past the last gated one can never win)."""
    gated = torch.nonzero(torch.as_tensor(gate).reshape(-1))
    return max(1, int(gated.max()) + 1) if gated.numel() else 1


def node_slices(n_cover: int, ctas: int):
    """Each CTA's (first node, node count): equal contiguous shares of
    ``[0, n_cover)``, as the kernel cuts them."""
    share = -(-n_cover // ctas)
    out = []
    for rank in range(ctas):
        base = min(rank * share, n_cover)
        out.append((base, min(share, n_cover - base)))
    return out


# -- the wrapper ----------------------------------------------------------------

def _expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def mega_allocate(*operands: torch.Tensor, n_queues: Optional[int] = None, **kw):
    """Run the whole allocate loop: ``(codes i32 [t_cap], stats i32 [8])``.

    Takes the JAX kernel's 26 operands (``OPERAND_NAMES``) and static
    arguments.  CPU operands run ``mega_allocate_reference``; CUDA operands
    launch the kernel, which raises if the launch is refused.  Multi-queue
    mode needs ``n_queues``, the session's queue count: it sizes the
    kernel's queue ledger, and every queue index of ``jqueue`` on a job
    lane must lie below it (the plain version checks; the kernel traps).
    With ``has_releasing`` the kernel runs one chunk a step whatever
    ``cohort`` asks, as the JAX kernel does: the gate cannot be bypassed."""
    if len(operands) != len(OPERAND_NAMES):
        raise TypeError(f"mega_allocate takes {len(OPERAND_NAMES)} operands")
    kw.pop("interpret", None)
    _check_mode(kw.get("multi_queue"), kw.get("qfair_ladder", False),
                kw.get("mesh"), kw.get("queue_delta", True), kw.get("queue_proportion", False),
                kw.get("overused_gate", False), operands)
    n_queues = _queues_for(kw, n_queues)
    if kw.get("qfair_ladder"):
        ops = dict(zip(OPERAND_NAMES, operands))
        if n_queues > 128 or ops["qf_share"].shape[1] != 128:
            raise ValueError("mega_allocate: the qfair ladder's tables hold 128 queues a rung")
    if operands[0].device.type == "cpu":
        if n_queues:
            ops = dict(zip(OPERAND_NAMES, operands))
            named = ops["jqueue"][0][ops["job_num"][0] > 0]
            if named.numel() and not (0 <= int(named.min()) and int(named.max()) < n_queues):
                raise ValueError(f"mega_allocate: a job lane names a queue outside "
                                 f"[0, {n_queues})")
        return mega_allocate_reference(*operands, **kw)
    return _launch(*operands, n_queues=n_queues, **kw)


def _launch(ns0, alloc_t, rel0, gate, plim, sig_req, task_sig, run_len,
            job_off, job_num, job_deficit, job_gang, job_prio, job_tb,
            js_drf0, drf_safe, drf_mask, msig, smask, sscore, jqueue, jq_des,
            jq_alloc0, qf_share, qf_over, misc, *, r_dim, weights,
            enforce_pod_count, comparators, cross_batch, batch_runs,
            has_releasing, use_static, score_bound, mins, cpu_idx, mem_idx,
            multi_queue, queue_proportion=False, overused_gate=False,
            queue_delta=True, qfair_ladder=False, cohort=1, t_cap=0,
            mesh=None, n_queues=0):
    global launches
    nb = ns0.shape[1]
    s_pad = sig_req.shape[1]
    t_rows = task_sig.shape[0]
    j_pad = job_off.shape[1]
    if not 0 < r_dim <= 8 or len(comparators) > 3 or nb <= 0:
        raise ValueError("mega_allocate: unsupported r_dim, comparators or node count")
    if any(float(w) for w in weights) and max(cpu_idx, mem_idx) >= r_dim:
        raise ValueError("mega_allocate: the score rows must lie within r_dim")
    f32, i32 = torch.float32, torch.int32
    _expect(ns0, "ns0", f32, (node_scratch_rows(False), nb))
    _expect(alloc_t, "alloc_t", f32, (8, nb))
    if has_releasing:
        _expect(rel0, "rel0", f32, (8, nb))
    _expect(gate, "gate", torch.bool, (1, nb))
    _expect(plim, "plim", f32, (1, nb))
    _expect(sig_req, "sig_req", f32, (16, s_pad))
    _expect(task_sig, "task_sig", i32, (t_rows, 128))
    _expect(run_len, "run_len", i32, (t_rows, 128))
    for name, t in (("job_off", job_off), ("job_num", job_num),
                    ("job_deficit", job_deficit), ("job_gang", job_gang),
                    ("job_prio", job_prio), ("job_tb", job_tb)):
        _expect(t, name, i32, (1, j_pad))
    _expect(js_drf0, "js_drf0", f32, (8, j_pad))
    _expect(drf_safe, "drf_safe", f32, (8, 1))
    _expect(drf_mask, "drf_mask", f32, (8, 1))
    _expect(misc, "misc", i32, (1, 8))
    static_rows = smask.shape[0]
    if use_static:
        _expect(msig, "msig", i32, (t_rows, 128))
        _expect(smask, "smask", f32, (static_rows, nb))
        _expect(sscore, "sscore", f32, (static_rows, nb))
        if static_rows <= 0:
            raise ValueError("mega_allocate: static-row mode needs at least one row")
    if multi_queue:
        _expect(jqueue, "jqueue", i32, (1, j_pad))
        _expect(jq_des, "jq_des", f32, (8, j_pad))
        _expect(jq_alloc0, "jq_alloc0", f32, (8, j_pad))
    qf_rows = qf_share.shape[0]
    if qfair_ladder:
        _expect(qf_share, "qf_share", f32, (qf_rows, 128))
        _expect(qf_over, "qf_over", f32, (qf_rows, 128))
    t_pad = t_rows * 128
    if t_cap <= 0:
        t_cap = t_pad
    if not batch_runs or has_releasing:
        cohort = 1
    cohort = max(1, int(cohort))

    plan = mega_plan(nb, r_dim, j_pad, s_pad, static_rows, use_static, n_queues,
                     bool(has_releasing), mesh=mesh)
    launch = _entry()
    dev = ns0.device
    out = torch.empty((t_rows + 1) * 128, dtype=i32, device=dev)
    stats = torch.empty(STATS_WIDTH, dtype=i32, device=dev)
    qlanes = None
    if multi_queue:  # the job lanes by queue (scratch)
        qlanes = torch.empty(j_pad, dtype=i32, device=dev)
    js_global = None
    if plan.job_ledger_in_global:
        js_global = torch.empty((plan.ctas, JOB_STATE.DRF + r_dim, j_pad), dtype=f32,
                                device=dev)

    args = _MegaArgs()
    for field, t in (
        ("ns0", ns0), ("alloc_t", alloc_t), ("gate", gate), ("plim", plim),
        ("sig_req", sig_req), ("task_sig", task_sig), ("run_len", run_len),
        ("job_off", job_off), ("job_num", job_num), ("job_def", job_deficit),
        ("job_gang", job_gang), ("job_prio", job_prio), ("job_tb", job_tb),
        ("js_drf0", js_drf0), ("drf_safe", drf_safe), ("drf_mask", drf_mask),
        ("misc", misc), ("out", out), ("stats", stats),
    ):
        setattr(args, field, t.data_ptr())
    args.js_global = js_global.data_ptr() if js_global is not None else None
    args.rel0 = rel0.data_ptr() if has_releasing else None
    args.has_releasing = int(bool(has_releasing))
    args.phase_clocks = phase_clocks.data_ptr() if phase_clocks is not None else None
    if use_static:
        args.msig, args.smask, args.sscore = (
            msig.data_ptr(), smask.data_ptr(), sscore.data_ptr())
    args.use_static = int(bool(use_static))
    args.static_rows = static_rows
    if multi_queue:
        args.jqueue, args.jq_des, args.jq_alloc0, args.qlanes = (
            jqueue.data_ptr(), jq_des.data_ptr(), jq_alloc0.data_ptr(), qlanes.data_ptr())
    if qfair_ladder:
        args.qf_share, args.qf_over = qf_share.data_ptr(), qf_over.data_ptr()
    args.multi_queue = int(bool(multi_queue))
    args.queue_proportion = int(bool(queue_proportion))
    args.overused_gate = int(bool(overused_gate))
    args.n_queues = n_queues
    args.queue_delta = int(bool(queue_delta))
    args.qfair_ladder = int(bool(qfair_ladder))
    args.qf_rows = qf_rows
    args.nb, args.s_pad, args.t_rows, args.t_cap = nb, s_pad, t_rows, t_cap
    args.j_pad, args.r_dim = j_pad, r_dim
    args.cpu_idx, args.mem_idx = cpu_idx, mem_idx
    args.enforce_pod_count = int(bool(enforce_pod_count))
    args.cross_batch = int(bool(cross_batch))
    args.batch_runs = int(bool(batch_runs))
    args.score_bound = int(bool(score_bound))
    args.cohort = cohort
    args.n_comp = len(comparators)
    for i, name in enumerate(comparators):
        args.comp[i] = _COMPARATOR_CODES[name]
    args.ctas, args.slice, args.smem_bytes = plan.ctas, plan.slice, plan.smem_bytes
    for field in ("off_queue", "off_js", "off_sig", "off_job", "off_static"):
        off = getattr(plan, field)
        setattr(args, field, -1 if off is None else off)
    args.w_lr, args.w_bal, args.w_bp = (float(w) for w in weights)
    for i in range(8):
        args.mins[i] = float(mins[i]) if i < len(mins) else 0.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = launch(ctypes.addressof(args), stream)
    if rc == _ERR_NO_CLUSTER:
        raise RuntimeError(f"mega_allocate: the card cannot schedule the plan's cluster {plan}")
    if rc != 0:
        raise RuntimeError(f"mega_allocate launch failed: CUDA error {rc}")
    launches += 1
    return out[:t_cap], stats


# -- the plain PyTorch version ------------------------------------------------

def mega_allocate_reference(
    ns0, alloc_t, rel0, gate, plim, sig_req, task_sig, run_len, job_off,
    job_num, job_deficit, job_gang, job_prio, job_tb, js_drf0, drf_safe,
    drf_mask, msig, smask, sscore, jqueue, jq_des, jq_alloc0, qf_share,
    qf_over, misc, *, r_dim, weights, enforce_pod_count, comparators,
    cross_batch, batch_runs, has_releasing, use_static, score_bound, mins,
    cpu_idx, mem_idx, multi_queue, queue_proportion=False,
    overused_gate=False, queue_delta=True, qfair_ladder=False, cohort=1,
    t_cap=0, mesh=None, interpret=None,
):
    """The kernel's function as a Python loop over steps on tensors, on
    whatever device the operands lie on.  Same operands, same
    ``(codes, stats)``, bit for bit."""
    del interpret
    _check_mode(multi_queue, qfair_ladder, mesh, queue_delta, queue_proportion, overused_gate)
    dev = ns0.device
    f32, i32 = torch.float32, torch.int32
    n = ns0.shape[1]
    t_rows = task_sig.shape[0]
    t_pad = t_rows * 128
    if t_cap <= 0:
        t_cap = t_pad
    j_pad = job_off.shape[1]
    if not batch_runs or has_releasing:
        cohort = 1
    cohort = max(1, int(cohort))
    lr_w, bal_w, bp_w = (float(w) for w in weights)
    max_steps = t_cap + 8
    neg_inf, pos_inf = float("-inf"), float("inf")

    # Live state: node ledger (idle rows + task count, and the releasing
    # rows with releasing capacity), job ledger, result.
    # In multi-queue mode the job ledger carries the queue rows as the JAX
    # kernel lays them out, replicated on the lanes of each queue's jobs:
    # the queue's live allocated, and (delta chain) its share and overused
    # flag, seeded here and refreshed for the winning queue per placement
    # (from the rung tables at the queue's placement count, QCOUNT, with the
    # ladder).  The full-recompute chain re-derives every share at each pop.
    queue_chain = multi_queue and (queue_proportion or overused_gate)
    use_qdelta = queue_chain and queue_delta
    use_full = queue_chain and not queue_delta
    use_ladder = use_qdelta and qfair_ladder
    ns = ns0.clone()
    js = torch.zeros((job_scratch_rows(multi_queue, use_qdelta), j_pad), dtype=f32, device=dev)
    js[JROW.DRF : JROW.QUEUE_ALLOC] = js_drf0
    jq_v = jqueue[0] if multi_queue else None
    if multi_queue:
        js[JROW.QUEUE_ALLOC : JROW.SHARE] = jq_alloc0
    if use_qdelta:
        share0, over0 = queue_share_overused(jq_des[:r_dim], jq_alloc0[:r_dim], mins, r_dim)
        if queue_proportion:
            js[JROW.SHARE] = share0
        if overused_gate:
            js[JROW.OVERUSED] = over0.to(f32)
    if use_ladder:
        js[JROW.QCOUNT] = 0.0
    out = torch.full(((t_rows + 1) * 128,), UNPLACED, dtype=i32, device=dev)

    # Read-only tables the scalar control flow indexes.
    tsig = task_sig.reshape(-1).tolist()
    rlen = run_len.reshape(-1).tolist()
    static_sig = msig.reshape(-1).tolist() if use_static else None
    static_rows = smask.shape[0]
    joff = job_off[0].tolist()
    jnum_l = job_num[0].tolist()
    jdef = job_deficit[0].tolist()
    n_real = int(misc[0, 0])

    lane_n = torch.arange(n, dtype=i32, device=dev)
    lane_j = torch.arange(j_pad, dtype=i32, device=dev)
    js_vec = torch.arange(1, MAX_BATCH + 1, dtype=i32, device=dev)
    jm1 = (js_vec - 1).to(f32)
    jnum = job_num[0]
    jnum_f = jnum.to(f32)
    jgang_f = job_gang[0].to(f32)
    jprio = job_prio[0]
    jtb = job_tb[0]
    gate_v = gate[0]
    plim_v = plim[0]
    a_c = alloc_t[cpu_idx]
    a_m = alloc_t[mem_idx]
    safe_c = torch.where(a_c > 0, a_c, 1.0)
    safe_m = torch.where(a_m > 0, a_m, 1.0)
    idle = ns[NROW.IDLE : NROW.IDLE + r_dim]
    tcount = ns[NROW.TASK_COUNT]
    rel = rel0[:r_dim].clone() if has_releasing else None

    def clip01(x):
        return torch.clamp(x, 0.0, 1.0)

    def scores(a_cpu, a_mem, s_cpu, s_mem, used_cpu, used_mem, base):
        """binpack / least-requested / balanced terms, in the kernel's order."""
        out_s = base
        if bp_w:
            fc = clip01(used_cpu / s_cpu)
            fm = clip01(used_mem / s_mem)
            out_s = out_s + bp_w * (((fc + fm) / 2.0) * 10.0)
        if lr_w:
            lc = clip01((a_cpu - used_cpu) / s_cpu)
            lm = clip01((a_mem - used_mem) / s_mem)
            out_s = out_s + lr_w * (((lc + lm) / 2.0) * 10.0)
        if bal_w:
            fc = clip01(used_cpu / s_cpu)
            fm = clip01(used_mem / s_mem)
            out_s = out_s + bal_w * ((1.0 - torch.abs(fc - fm)) * 10.0)
        return out_s

    def chain_select(cursor: int) -> int:
        """Comparator chain over the job lanes: in multi-queue mode first the
        queue pop (jobs of overused queues dropped, the least-share queue,
        the lowest queue rank), else the lanes up to the cursor; then
        priority -> gang -> drf, the creation/uid rank, lowest lane on ties;
        HALT when none is left."""
        cand = (js[JROW.LEFT] == 0.0) & (js[JROW.CONSUMED] < jnum_f) & (jnum > 0)
        if multi_queue:
            if use_full:
                # The full-recompute chain: every lane's queue share and
                # overused flag from the live allocated rows.
                share_l, over_l = queue_share_overused(
                    jq_des[:r_dim], js[JROW.QUEUE_ALLOC : JROW.QUEUE_ALLOC + r_dim], mins,
                    r_dim)
            elif use_qdelta:
                share_l, over_l = js[JROW.SHARE], js[JROW.OVERUSED] >= 0.5
            # Without a queue chain (no proportion) the queues pop by rank
            # alone, and the job ledger has no share rows.
            if overused_gate:
                cand = cand & ~over_l
            if queue_proportion:
                maskedq = torch.where(cand, share_l, pos_inf)
                cand = cand & (maskedq == maskedq.min())
            qrank = torch.where(cand, jq_v, _BIG_I32)
            cand = cand & (qrank == qrank.min())
        else:
            cand = cand & (lane_j <= cursor)
        for name in comparators:
            if name == "priority":
                masked = torch.where(cand, -jprio, _BIG_I32)
            elif name == "gang":
                key = ((jgang_f - js[JROW.ALLOCATED]) <= 0.0).to(i32)
                masked = torch.where(cand, key, _BIG_I32)
            else:  # drf
                frac = torch.where(
                    drf_mask > 0.0, js[JROW.DRF : JROW.QUEUE_ALLOC] / drf_safe, 0.0
                )
                masked = torch.where(cand, frac.max(dim=0).values, pos_inf)
            cand = cand & (masked == masked.min())
        tbv = torch.where(cand, jtb, _BIG_I32)
        low = int(tbv.min())
        if low >= _BIG_I32:
            return HALT
        return int(torch.where(tbv == low, lane_j, j_pad).min())

    def alive(cur, cursor, n_dirty) -> bool:
        if multi_queue:
            # The selection finds exhaustion itself (HALT).
            return cur != HALT
        return cur >= 0 or (cur != HALT and (cursor < n_real or n_dirty > 0))

    cur, cursor, n_dirty = -1, 0, 0
    steps = coh_steps = chunk_pl = qd_evt = qf_evt = 0
    while steps < max_steps and alive(cur, cursor, n_dirty):
        # ---- selection: the full chain in multi-queue mode (live shares
        # move with every placement), else the cursor ----
        if cur == -1 and multi_queue:
            sel = chain_select(0)
        elif cur == -1:
            if n_dirty > 0:
                sel = chain_select(cursor)
            else:
                sel = cursor if cursor < n_real else HALT
        else:
            sel = cur
        # The cursor and the dirty count are cursor-mode state: inert in
        # multi-queue mode.
        newly = cur == -1 and sel >= 0 and not multi_queue
        cursor_r = cursor + int(newly and sel == cursor)
        dirty_r = n_dirty - int(newly and sel != cursor)
        cur_r = sel

        jb = min(max(sel, 0), j_pad - 1)
        cons_c, nalloc_c = js[[JROW.CONSUMED, JROW.ALLOCATED], jb].tolist()
        num_v, deficit_v = jnum_l[jb], jdef[jb]
        t_c = min(max(joff[jb] + int(cons_c), 0), t_pad - 1)
        sig = tsig[t_c]
        rl_c = rlen[t_c]
        if use_static:
            # The task's static-signature rows, read once per step; cohort
            # chunks reuse them (a run shares its rows by construction).
            ms = min(max(static_sig[t_c], 0), static_rows - 1)
            mrow, srow = smask[ms], sscore[ms]
        reqs = sig_req[SIG_REQ.REQ : SIG_REQ.REQ + r_dim, sig]
        initqs = sig_req[SIG_REQ.INIT : SIG_REQ.INIT + r_dim, sig]
        single0 = num_v == 1
        act = sel >= 0

        # ---- cohort chunks: chunk 0 is the step's placement; chunks 1.. place
        # the next segment of the same cohort on the live ledgers ----
        for c in range(cohort):
            if not act:
                break
            # fit + score + masked argmax over every node; with releasing
            # capacity a task fits on idle OR releasing
            feas_idle = gate_v
            for r in range(r_dim):
                feas_idle = feas_idle & (
                    (initqs[r] < idle[r]) | (torch.abs(idle[r] - initqs[r]) < mins[r])
                )
            feas = feas_idle
            if has_releasing:
                feas_rel = gate_v
                for r in range(r_dim):
                    feas_rel = feas_rel & (
                        (initqs[r] < rel[r]) | (torch.abs(rel[r] - initqs[r]) < mins[r])
                    )
                feas = feas_idle | feas_rel
            if use_static:
                feas = feas & (mrow > 0.0)
            if enforce_pod_count:
                feas = feas & (tcount < plim_v)
            score = torch.zeros(n, dtype=f32, device=dev)
            if lr_w or bal_w or bp_w:
                req_c = a_c - idle[cpu_idx] + reqs[cpu_idx]
                req_m = a_m - idle[mem_idx] + reqs[mem_idx]
                score = scores(a_c, a_m, safe_c, safe_m, req_c, req_m, score)
            if use_static:
                score = score + srow
            masked = torch.where(feas, score, neg_inf)
            maxv = masked.max()
            best_t = torch.where(masked == maxv, lane_n, n).min().clamp(max=n - 1)
            feasible, best = torch.stack([(maxv > neg_inf).to(best_t.dtype), best_t]).tolist()
            placed = bool(feasible)
            failed = not placed
            # The winner's idle fit decides: allocate on idle, else pipeline
            # onto its releasing capacity.
            alloc_here = placed and (not has_releasing or bool(feas_idle[best]))
            pipe_here = placed and not alloc_here

            # run batching on the winner (top-2 score bound unless binpack-only)
            m = 1
            if batch_runs and alloc_here:
                room = deficit_v - int(nalloc_c) if deficit_v > 0 else 1
                if cross_batch and single0 and dirty_r == 0:
                    room = MAX_BATCH
                hi0 = min(rl_c, MAX_BATCH, room)
                if enforce_pod_count:
                    hi0 = min(hi0, int((plim_v[best] - tcount[best]).item()))
                hi0 = max(hi0, 1)
                ok = torch.ones(MAX_BATCH, dtype=torch.bool, device=dev)
                for r in range(r_dim):
                    avail = idle[r, best] - jm1 * reqs[r]
                    ok = ok & (
                        (initqs[r] < avail) | (torch.abs(avail - initqs[r]) < mins[r])
                    )
                if score_bound:
                    others = masked.clone()
                    others[best] = neg_inf
                    second = others.max()
                    second_idx = torch.where(others == second, lane_n, n).min()
                    a_c_b, a_m_b = a_c[best], a_m[best]
                    avail_c = idle[cpu_idx, best] - jm1 * reqs[cpu_idx]
                    avail_m = idle[mem_idx, best] - jm1 * reqs[mem_idx]
                    reqd_c = a_c_b - avail_c + reqs[cpu_idx]
                    reqd_m = a_m_b - avail_m + reqs[mem_idx]
                    s_js = scores(
                        a_c_b, a_m_b, safe_c[best], safe_m[best], reqd_c, reqd_m,
                        torch.zeros(MAX_BATCH, dtype=f32, device=dev),
                    )
                    if use_static:
                        s_js = s_js + srow[best]
                    ok_s = (s_js > second) | ((s_js == second) & (best < second_idx))
                    first_false = torch.where(~ok_s, js_vec, MAX_BATCH + 1).min()
                    ok = ok & (js_vec < first_false)
                m = int(torch.where(ok & (js_vec <= hi0), js_vec, 1).max())
            cross_active = cross_batch and single0 and alloc_here
            consumed = m if alloc_here else 1
            m_alloc = float(m) if alloc_here else 0.0
            pipe_f = 1.0 if pipe_here else 0.0

            # node ledger: the winner's column
            if alloc_here:
                idle[:, best] -= reqs * m_alloc
                tcount[best] += m_alloc
            elif pipe_here:
                rel[:, best] -= reqs * pipe_f
                tcount[best] += pipe_f

            # job ledger: one lane, or the window of a cross-job batch
            k = m if cross_active else 1
            win = slice(jb, min(jb + k, j_pad))
            js[JROW.CONSUMED, win] += 1.0 if cross_active else float(consumed)
            js[JROW.ALLOCATED, win] += 1.0 if cross_active else m_alloc
            js[JROW.LEFT, win] += 0.0 if cross_active else float(failed)
            drf_scale = 1.0 if cross_active else m_alloc + pipe_f
            js[JROW.DRF : JROW.DRF + r_dim, win] += (reqs * drf_scale)[:, None]
            if multi_queue:
                # proportion's allocate handler: the placement grows its
                # queue's allocated, on every lane of that queue; the delta
                # chain then re-derives the queue's share and overused flag
                # from the values just written.  With the ladder the queue's
                # placement count grows instead, and the share and flag are
                # the rung tables' at that count (queues on the columns).
                qwin = jq_v == jq_v[jb]
                if use_ladder:
                    js[JROW.QCOUNT] += drf_scale * qwin.to(f32)
                    rung, q_sel = int(js[JROW.QCOUNT, jb]), int(jq_v[jb])
                    if queue_proportion:
                        js[JROW.SHARE] = torch.where(qwin, qf_share[rung, q_sel],
                                                     js[JROW.SHARE])
                    if overused_gate:
                        js[JROW.OVERUSED] = torch.where(qwin, qf_over[rung, q_sel],
                                                        js[JROW.OVERUSED])
                    qf_evt += int(placed)
                else:
                    qa = js[JROW.QUEUE_ALLOC : JROW.QUEUE_ALLOC + r_dim]
                    qa += (reqs * drf_scale)[:, None] * qwin.to(f32)
                if use_qdelta and not use_ladder:
                    share_new, over_new = queue_share_overused(
                        jq_des[:r_dim, jb], qa[:, jb], mins, r_dim)
                    if queue_proportion:
                        js[JROW.SHARE] = torch.where(qwin, share_new, js[JROW.SHARE])
                    if overused_gate:
                        js[JROW.OVERUSED] = torch.where(qwin, over_new.to(f32),
                                                        js[JROW.OVERUSED])
                    qd_evt += int(placed)

            # result codes of the consumed tasks
            code = best if alloc_here else (PIPE_BASE - best if pipe_here else FAILED)
            out[t_c : t_c + consumed] = code

            # pop end / running scalars (a pipelined placement counts
            # toward readiness as the JAX kernel's ``placed`` does)
            row_after_alloc = nalloc_c + (1.0 if cross_active else m_alloc)
            became_ready = placed and row_after_alloc >= deficit_v
            cons_after = cons_c + (1.0 if cross_active else float(consumed))
            drained = cons_after >= num_v
            end_pop = failed or became_ready or drained
            cur_r = -1 if end_pop else jb
            dirty_r += int(became_ready and not drained)
            if cross_batch:
                cursor_r += (m - 1 if cross_active else 0) + (int(single0) if c else 0)
            if c >= 1 and alloc_here:
                chunk_pl += m
            if c + 1 < cohort:
                cont_injob = alloc_here and not end_pop and rl_c > consumed
                cont_cross = cross_active and dirty_r == 0 and rl_c > m
                act_next = cont_injob or cont_cross
                if c == 0:
                    coh_steps += int(act_next)
                t_c = min(t_c + consumed, t_pad - 1)
                rl_c -= consumed
                if cont_cross:
                    jb += m
                    cons_c, nalloc_c = 0.0, 0.0
                else:
                    cons_c += 1.0 if cross_active else float(consumed)
                    nalloc_c += m_alloc
                act = act_next
        cur, cursor, n_dirty = cur_r, cursor_r, dirty_r
        steps += 1

    stats = torch.zeros(STATS_WIDTH, dtype=i32, device=dev)
    stats[STATS.STEPS] = steps
    stats[STATS.COHORT_STEPS] = coh_steps
    stats[STATS.CHUNK_PLACED] = chunk_pl
    stats[STATS.QDELTA_UPDATES] = qd_evt
    stats[STATS.QFULL_RECOMPUTES] = steps if use_full else 0
    stats[STATS.QFAIR_LOOKUPS] = qf_evt
    return out[:t_cap], stats


# -- host packers ---------------------------------------------------------------

def request_signature_ids(req_s: np.ndarray, init_s: np.ndarray):
    """Dense ids over identical scaled (request, init-request) row pairs,
    plus the unique rows themselves: the kernel's per-signature request
    table and its per-task signature column."""
    from scheduler_tpu_torch.api.job_info import unique_row_codes

    return unique_row_codes(np.concatenate([req_s, init_s], axis=1))


def pack_lane_i32(arr: np.ndarray, lanes: int) -> np.ndarray:
    out = np.zeros((1, lanes), dtype=np.int32)
    out[0, : arr.shape[0]] = arr
    return out


def pack_task_table_i32(arr: np.ndarray, t_pad: int, fill: int = 0) -> np.ndarray:
    """Pack a per-task i32 column into the windowed [ceil(t_pad/128), 128]
    cohort-table layout."""
    rows = task_table_rows(t_pad)
    out = np.full((rows, 128), fill, dtype=np.int32)
    out.reshape(-1)[: arr.shape[0]] = arr
    return out


def build_node_ledgers(idle: torch.Tensor, task_count: torch.Tensor,
                       releasing: torch.Tensor, nb: int, r: int, has_releasing: bool):
    """Kernel-layout node ledgers from [N, R] node state: the packed [16, N]
    idle + task-count block (rows 0..r-1 idle, row 8 task count) and the
    [8, N] releasing block (rows 0..r-1; zeros without releasing
    capacity)."""
    dev = idle.device
    ns0 = torch.zeros((NROW.RELEASING, nb), dtype=torch.float32, device=dev)
    ns0[NROW.IDLE : NROW.IDLE + r] = idle.T
    ns0[NROW.TASK_COUNT] = task_count.to(torch.float32)
    rel_t = torch.zeros((8, nb), dtype=torch.float32, device=dev)
    if has_releasing:
        rel_t[:r] = releasing.T
    return ns0, rel_t
