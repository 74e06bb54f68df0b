"""Proportion's queue-share solve on the device, and the class ladder.

This is the port of ``scheduler_tpu/ops/qfair.py`` (an XLA program in the
JAX package, not a Pallas kernel).  Two halves:

(a) **The deserved fixed point** (``qfair_solve``): proportion's water-fill
    over queues x resources as a fixed budget of rounds in float64, one
    launch of ``csrc/qfair_solve.cu``.  Every fold whose order matters on
    the host (the unmet-weight sum, the increased and decreased sums) runs
    queue by queue in the host's order, so the result is bit for bit the
    host loop's (``plugins/proportion.py`` ``_solve_host``, the
    ``SCHEDULER_TORCH_QFAIR=host`` kill-switch).  ``converged_at`` is
    evidence: a budget that runs out makes proportion fall back to the host
    loop, so a short budget costs host time, never different shares.

(b) **The per-queue share/overused ladder** (``single_class_queues``,
    ``build_ladder``): where every queue's candidates share one request
    class and a step places one copy, a queue's allocated row after k
    placements is a function of k alone, so its share and overused flag
    can be tabled by placement count.  ``mega_allocate``'s qfair-ladder
    mode reads them from the table instead of re-deriving them per
    placement; the table folds the same float32 values in the same order,
    so a lookup is bit for bit the value it replaces.

``qfair_solve`` runs the kernel on CUDA tensors and its plain PyTorch
version (``qfair_solve_reference``) on CPU tensors; each launch adds one to
``launches``.  The host half is numpy, copied from the JAX module.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.layout import QFAIR_STATS

# Ladder depth admission cap (rungs a queue).  Deeper queues keep the delta
# chain.
LADDER_CAP = 1024

# Launches of the CUDA kernel (the CPU path never counts).
launches = 0


def qfair_flavor() -> str:
    """``SCHEDULER_TORCH_QFAIR``: ``device`` (default: the fixed-round solve
    and the class ladder) or ``host`` (proportion's host water-fill and the
    delta chain: the kill-switch)."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_QFAIR", "device", choices=("device", "host"))


def qfair_iters() -> int:
    """``SCHEDULER_TORCH_QFAIR_ITERS``: the water-fill's round budget (0:
    Q + 4; each productive round caps a queue or drains the pool, so Q + 4
    covers every convergent instance).  A solve that has not converged
    within the budget makes proportion fall back to the host loop."""
    from scheduler_tpu_torch.utils.envflags import env_int

    return env_int("SCHEDULER_TORCH_QFAIR_ITERS", 0, minimum=0, maximum=10_000)


# -- the water-fill ------------------------------------------------------------------

def _entry():
    fn = cuda_build.load().qfair_solve_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# Dims a launch takes: the kernel keeps remaining, increased and decreased
# (24 bytes a dim) in shared memory beside the delta tile.
MAX_DIMS = 2048
# The launch plan's constants (csrc/qfair_solve.cu): threads of the one CTA,
# and the shared memory a block can use on the H100.
THREADS = 1024
MIN_THREADS = 64
SMEM_LIMIT = 232_448 - 1024  # less the kernel's static scalars


def qfair_plan(q_n: int, r_n: int) -> Tuple[int, bool, int]:
    """The launch: ``(threads, on_chip, smem_bytes)``.  A warp a queue up to
    ``THREADS`` (and at least a warp a fold of each dim beside the weight
    fold's warp); the [Q, R] delta tile and the queue list in shared
    memory where they fit (``on_chip``), else in a global scratch tile."""
    want = max(32 * q_n, 2 * r_n + 32, MIN_THREADS)
    threads = min(THREADS, -(-want // 32) * 32)
    pool = 24 * r_n
    tile = 8 * q_n * r_n + 4 * q_n
    on_chip = pool + tile <= SMEM_LIMIT
    return threads, on_chip, pool + (tile if on_chip else 0)


def qfair_solve(weights, request, total, req_hs, total_hs, mins, *, iters: int, mesh=None):
    """One fleet's water-fill: ``(deserved f64 [Q, R], met bool [Q],
    qf_raw i32 [2])``.  ``weights`` f64 [Q] in the host's queue order,
    ``request`` f64 [Q, R], ``total`` f64 [R] (the pool), ``req_hs`` bool [Q]
    (each request's scalar-map presence), ``total_hs`` (the pool's), ``mins``
    f64 [R] (the vocabulary's epsilons); ``iters`` rounds.  CPU tensors run
    ``qfair_solve_reference``; CUDA tensors launch the kernel, which raises
    if the launch fails.  On a node mesh (``mesh``) the solve runs once, on
    the mesh's first device, where its operands must lie: the JAX package's
    replicated twins (``scheduler_tpu/ops/qfair.py:199-215``) compute the
    same fleet on every device and read nothing across them."""
    if mesh is not None and request.device != mesh.first:
        raise ValueError(f"qfair_solve: on a mesh the operands lie on its first device "
                         f"{mesh.first}, not {request.device}")
    if request.device.type == "cpu":
        return qfair_solve_reference(weights, request, total, req_hs, total_hs, mins,
                                     iters=iters)
    return _launch(weights, request, total, req_hs, total_hs, mins, iters=iters)


def _launch(weights, request, total, req_hs, total_hs, mins, *, iters):
    global launches
    q_n, r_n = request.shape
    if r_n < 2 or r_n > MAX_DIMS:
        raise ValueError(f"qfair_solve: {r_n} resource dims (2 to {MAX_DIMS})")
    f64 = torch.float64
    for name, t, dtype, shape in (
        ("weights", weights, f64, (q_n,)), ("request", request, f64, (q_n, r_n)),
        ("total", total, f64, (r_n,)), ("req_hs", req_hs, torch.bool, (q_n,)),
        ("mins", mins, f64, (r_n,)),
    ):
        if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"qfair_solve: {name} must be a CUDA {dtype} tensor of "
                             f"shape {shape}")
        if not t.is_contiguous():
            raise ValueError(f"qfair_solve: {name} must be contiguous")
    dev = request.device
    threads, on_chip, smem = qfair_plan(q_n, r_n)
    deserved = torch.empty((q_n, r_n), dtype=f64, device=dev)
    met = torch.empty(q_n, dtype=torch.bool, device=dev)
    d_hs = torch.empty(q_n, dtype=torch.bool, device=dev)  # scratch
    qf_raw = torch.empty(2, dtype=torch.int32, device=dev)
    # The global arm's delta tile and queue list.
    delta = None if on_chip else torch.empty((q_n, r_n), dtype=f64, device=dev)
    order = None if on_chip else torch.empty(q_n, dtype=torch.int32, device=dev)
    rc = _entry()(weights.data_ptr(), request.data_ptr(), total.data_ptr(), req_hs.data_ptr(),
                  mins.data_ptr(), d_hs.data_ptr(), int(bool(total_hs)), q_n, r_n, int(iters),
                  deserved.data_ptr(), met.data_ptr(), qf_raw.data_ptr(),
                  None if on_chip else delta.data_ptr(), None if on_chip else order.data_ptr(),
                  threads, int(on_chip), smem, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qfair_solve launch failed: CUDA error {rc}")
    launches += 1
    return deserved, met, qf_raw


def qfair_solve_reference(weights, request, total, req_hs, total_hs, mins, *, iters: int):
    """The kernel's function as float64 tensor operations, round by round and
    queue by queue (``scheduler_tpu/ops/qfair.py:93-196``): the unmet-weight
    sum folded in queue order; a queue's grant ``remaining * (w / tw) + 0``
    (multiply, then add: no fused multiply-add), added to its deserved;
    ``ResourceVec.less(request, deserved)`` with its scalar-map branch caps
    it at its request; increased and decreased fold in queue order; the pool
    is drained when every dim is under its epsilon.  Rounds after the fixed
    point are no-ops in the reference, so both versions stop there;
    ``qf_raw`` still reports the whole budget as ``ITERATIONS``."""
    q_n, r_n = request.shape
    f64 = torch.float64
    dev = request.device
    zero = torch.zeros((), dtype=f64, device=dev)
    deserved = torch.zeros((q_n, r_n), dtype=f64, device=dev)
    d_hs = [False] * q_n
    met = [False] * q_n
    req_hs_l = [bool(x) for x in req_hs.tolist()]
    remaining = total.clone()
    rem_hs = bool(total_hs)
    done, rounds = False, 0
    for _ in range(iters):
        if done:
            break
        tw = zero
        for qi in range(q_n):
            tw = tw + (zero if met[qi] else weights[qi])
        if float(tw) == 0.0:
            done = True  # nothing left to share: the round changes nothing
            break
        inc = torch.zeros(r_n, dtype=f64, device=dev)
        dec = torch.zeros(r_n, dtype=f64, device=dev)
        for qi in range(q_n):
            if met[qi]:
                continue  # a met queue keeps its row: delta 0
            old = deserved[qi]
            grant = remaining * (weights[qi] / tw) + 0.0
            new_d = old + grant
            new_hs = d_hs[qi] or rem_hs
            req = request[qi]
            strict = bool((req[0] < new_d[0]) & (req[1] < new_d[1]))
            scalar_ok = bool(torch.where(req[2:] != 0, req[2:] < new_d[2:], True).all())
            capped = (scalar_ok if req_hs_l[qi] else new_hs) and strict
            if capped:
                fin = torch.minimum(new_d, req)
                d_hs[qi] = bool((fin[2:] != 0).any())
                met[qi] = True
            else:
                fin = new_d
                d_hs[qi] = new_hs
            delta = fin - old
            inc = inc + torch.where(delta > 0, delta, zero)
            dec = dec + torch.where(delta < 0, -delta, zero)
            deserved[qi] = fin
        remaining = (remaining - inc) + dec
        rem_hs = rem_hs or bool((dec[2:] != 0).any())
        rounds += 1
        if bool((remaining < mins).all()):
            done = True
    qf_raw = torch.tensor([0, 0], dtype=torch.int32, device=dev)
    qf_raw[QFAIR_STATS.ITERATIONS] = iters
    qf_raw[QFAIR_STATS.CONVERGED_AT] = rounds if done else -1
    return deserved, torch.tensor(met, dtype=torch.bool, device=dev), qf_raw


def solve_deserved(
    weights: np.ndarray,          # f64 [Q]    queue weights, in the host's queue order
    request: np.ndarray,          # f64 [Q, R] each queue's aggregate request
    total: np.ndarray,            # f64 [R]    the cluster's total (the pool)
    req_has_scalars: np.ndarray,  # bool [Q]   each request's scalar-map presence
    total_has_scalars: bool,      # the pool's scalar-map presence
    mins: np.ndarray,             # f64 [R]    the vocabulary's epsilons
    device=None,
    mesh=None,
) -> dict:
    """Run the water-fill on ``device`` (None: the card; with a node
    ``mesh``, its first device) and decode the evidence: ``{"deserved",
    "met", "iterations", "converged_at", "converged"}``.  ``converged``
    False means the round budget ran out: the caller (proportion) falls
    back to the host loop and records why."""
    from scheduler_tpu_torch.ops.device import resolve_device

    dev = mesh.first if mesh is not None else resolve_device(device)
    q_n = int(weights.shape[0])
    iters = qfair_iters() or q_n + 4

    def f64(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev)

    deserved, met, qf_raw = qfair_solve(
        f64(weights), f64(request), f64(total),
        torch.from_numpy(np.asarray(req_has_scalars, dtype=bool)).to(dev),
        bool(total_has_scalars), f64(mins), iters=iters, mesh=mesh)
    stats = qfair_stats_dict(qf_raw.cpu().numpy())
    return {
        "deserved": deserved.cpu().numpy(),
        "met": met.cpu().numpy(),
        "converged": stats["converged_at"] >= 0,
        **stats,
    }


def qfair_stats_dict(qf_raw: np.ndarray) -> dict:
    """Decode the evidence row (``converged_at`` -1: the round budget ran
    out before the fixed point)."""
    return {
        "iterations": int(qf_raw[QFAIR_STATS.ITERATIONS]),
        "converged_at": int(qf_raw[QFAIR_STATS.CONVERGED_AT]),
    }


def shares_host(deserved: np.ndarray, allocated: np.ndarray) -> np.ndarray:
    """Proportion's ``_update_share`` for every queue at once: the max over
    the deserved vector's resource names of allocated / deserved, in float64
    (cpu and memory always count, with 0/0 -> 0 and x/0 -> 1; scalar dims
    only where deserved is nonzero)."""
    d = deserved
    a = allocated
    ratio = np.where(
        d != 0.0, a / np.where(d != 0.0, d, 1.0),
        np.where(a != 0.0, 1.0, 0.0),
    )
    if d.shape[1] > 2:
        ratio[:, 2:] = np.where(d[:, 2:] != 0.0, ratio[:, 2:], 0.0)
    return np.maximum(ratio.max(axis=1, initial=0.0), 0.0)


# -- the class ladder (ops/fused.py staging) ------------------------------------------

def single_class_queues(
    sig_of_task: np.ndarray,    # i64 [T] request-signature id of each task
    queue_of_task: np.ndarray,  # i64 [T] queue index of each task
    q_n: int,
) -> Tuple[bool, np.ndarray, Optional[np.ndarray]]:
    """The ladder's admission: ``(ok, counts, class_of_queue)``.  ``ok`` iff
    every queue's candidates share one request signature (a queue with no
    task qualifies: only its rung 0 is reachable); ``counts`` is each
    queue's candidate count (its reachable depth), ``class_of_queue`` its
    signature id (-1: no task)."""
    counts = np.bincount(queue_of_task, minlength=q_n).astype(np.int64)
    class_of = np.full((q_n,), -1, dtype=np.int64)
    if sig_of_task.size:
        order = np.argsort(queue_of_task, kind="stable")
        qs = queue_of_task[order]
        sig = sig_of_task[order]
        first = np.unique(qs, return_index=True)[1]
        class_of[qs[first]] = sig[first]
        if not bool(np.all(sig == class_of[qs])):
            return False, counts, None
    return True, counts, class_of


def build_ladder(
    q_deserved: np.ndarray,   # f32 [Q, R] deserved rows (device units)
    q_alloc0: np.ndarray,     # f32 [Q, R] allocated rows at session open
    req_rows: np.ndarray,     # f32 [Q, R] each queue's class request row
    counts: np.ndarray,       # i64 [Q]    each queue's candidate count
    mins: np.ndarray,         # f32 [R]    epsilons (device units)
    r_dim: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The share/overused ladder: ``(share f32 [Q, K], overused bool [Q, K])``
    with K = max(counts) + 1.  Rung k of a queue is its value after k
    placements of its class request: the allocated row is a sequential
    float32 fold (``np.add.accumulate``, one add a placement, as the
    kernels add), and share and overused follow the kernels' float32
    arithmetic dim by dim (``megakernel.queue_share_overused``).  Rungs
    past a queue's own count are never reached."""
    q_n = q_deserved.shape[0]
    k_n = int(counts.max()) + 1 if q_n else 1
    steps = np.broadcast_to(
        req_rows[:, None, :], (q_n, k_n - 1, req_rows.shape[1])
    ) if k_n > 1 else np.zeros((q_n, 0, req_rows.shape[1]), np.float32)
    chain = np.add.accumulate(
        np.concatenate([q_alloc0[:, None, :], steps], axis=1, dtype=np.float32),
        axis=1,
    )
    one = np.float32(1.0)
    zero = np.float32(0.0)
    share = None
    over = None
    for r in range(r_dim):
        d = np.ascontiguousarray(q_deserved[:, r, None])
        a = chain[:, :, r]
        fr = np.where(d > zero, a / np.where(d > zero, d, one), zero)
        if r < 2:  # cpu and memory (the vocabulary's fixed first dims)
            fr = np.where((d <= zero) & (a > zero), one, fr)
        share = fr if share is None else np.maximum(share, fr)
        le = (d - a) < mins[r]
        over = le if over is None else over & le
    return share.astype(np.float32, copy=False), over
