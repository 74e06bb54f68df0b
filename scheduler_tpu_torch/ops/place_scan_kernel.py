"""One job pop's placement scan as ONE CUDA kernel launch.

This replaces ``scheduler_tpu/ops/placement.py:71-137`` ``_place_scan`` (a
``lax.scan`` under ``jax.jit``: XLA code, not a Pallas kernel).  As PyTorch
operations on the card its step would be some hundred launches and a host
read per task; a pop of the per-pop engine (``ops/allocator.py``) scans up
to a gang's worth of tasks, and a north-star cycle some 100,000, so the
port gives it a kernel.  The source is ``csrc/place_scan.cu``, built with
the port's other kernels at first use (``ops/cuda_build.py``) and bound
through a plain C entry point with ``ctypes``.

* ``place_scan`` — the wrapper.  CUDA tensors launch the kernel on the
  current stream (or raise); CPU tensors run ``place_scan_reference``.
  Each launch adds one to ``launches``.
* ``place_scan_reference`` — the plain PyTorch version: the scan body of
  the JAX function, one task at a time.
* ``scan_plan`` — the kernel's launch plan: one thread-block cluster of
  ``ctas`` CTAs, each owning an equal contiguous slice of ``[0, n_active)``
  (``node_slices``), held in shared memory (the on-chip arm) where it fits
  and the pop scans more than one task, else read in place (the global
  arm).  A plan the card cannot run makes the launch raise; nothing falls
  back.

Both update ``idle``, ``releasing`` and ``task_count`` in place and return
an int32 ``[3, t]`` tensor on the inputs' device: row 0 the chosen node of
each scanned task (-1: not placed), row 1 1 where the task was pipelined,
row 2 1 at the first task no node could take (the scan stops there).

The scan, per task in order until it stops: the epsilon fit of the task's
init request against the idle and the releasing rows, ANDed with the task's
static mask row and (``enforce_pod_count``) ``task_count < pods_limit``;
the score ``static_score + dynamic_score`` (least-requested, balanced,
binpack, in that order; no static score rows: ``0.0 + dynamic_score``);
the masked argmax, lowest index on ties (all -inf: node 0 and nothing
placed); allocate on idle where the winner fits idle, else pipeline onto
releasing; after each placement the JobReady break once the allocations
reach ``ready_deficit``.  The first task with no feasible node is failed
and stops the scan.  Node columns at or past ``n_active`` (pad nodes) are
infeasible.

Task rows come by index (``rows``) from the session's ``[T, R]`` request
tensors and ``[T, N]`` static tensors, which stay where they are: a pop
gathers nothing.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.predicates import fit_mask
from scheduler_tpu_torch.ops.scoring import dynamic_score

# Launches of the CUDA kernel (the CPU path never counts).
launches = 0

# Resource dims the kernel keeps in shared memory (the vocabulary's width).
MAX_R = 32

# The launch plan's constants (csrc/place_scan.cu): threads a CTA (1,024 at
# two resource dims, else 512), the largest cluster (16 is a non-portable
# size), the nodes a CTA takes before the plan doubles the cluster, a
# block's shared memory on the H100 and the part of it the kernel's static
# arrays keep.
THREADS_R2 = 1024
THREADS = 512
MAX_CTAS = 16
NODES_PER_CTA = 1024
SMEM_LIMIT = 232_448
STATIC_SMEM = 2048
_ERR_NO_CLUSTER = 10001


@dataclass(frozen=True)
class ScanPlan:
    """A launch of the kernel: ``ctas`` CTAs of ``threads`` threads, each
    owning ``slice`` nodes; ``on_chip``: the slice in shared memory
    (``smem_bytes`` of it), else the global arm."""

    ctas: int
    slice: int
    on_chip: bool
    smem_bytes: int
    threads: int

    def describe(self) -> dict:
        return {"ctas": self.ctas, "threads": self.threads, "slice": self.slice,
                "arm": "shared" if self.on_chip else "global", "smem_bytes": self.smem_bytes}


def slice_words(r: int, has_weights: bool, enforce_pod_count: bool) -> int:
    """4-byte words a node of an on-chip slice takes: the idle and the
    releasing rows, the task count, the allocatable cpu and memory columns
    where a score weight is non-zero, the pod limit under the gate."""
    return 2 * r + 1 + 2 * bool(has_weights) + bool(enforce_pod_count)


def scan_plan(n_active: int, r: int, t: int, weights: Tuple[float, float, float],
              enforce_pod_count: bool, ctas: Optional[int] = None,
              arm: Optional[str] = None) -> ScanPlan:
    """The plan for a pop of ``t`` tasks over ``n_active`` nodes of ``r``
    dims.  By default the smallest cluster (1, 2, 4, 8 or 16 CTAs) that
    gives a CTA at most ``NODES_PER_CTA`` nodes, and the on-chip arm where
    the slice fits and ``t`` > 1 (a one-task pop reads each node once
    either way).  ``ctas`` and ``arm`` ("shared" or "global") force a plan;
    a shared arm that does not fit raises."""
    if ctas is None:
        ctas = 1
        while ctas < MAX_CTAS and ctas * NODES_PER_CTA < n_active:
            ctas *= 2
    if ctas not in (1, 2, 4, 8, 16):
        raise ValueError(f"place_scan: a cluster of {ctas} CTAs (1, 2, 4, 8 or 16)")
    share = -(-max(int(n_active), 0) // ctas)
    slice_ = -(-share // 4) * 4
    need = slice_ * slice_words(r, any(weights), enforce_pod_count) * 4
    fits = need <= SMEM_LIMIT - STATIC_SMEM
    if arm is None:
        arm = "shared" if fits and t > 1 else "global"
    if arm not in ("shared", "global"):
        raise ValueError(f"place_scan: arm {arm!r} (shared or global)")
    if arm == "shared" and not fits:
        raise ValueError(f"place_scan: a slice of {slice_} nodes x {r} dims ({need} bytes) "
                         f"does not fit a CTA's shared memory")
    on_chip = arm == "shared"
    return ScanPlan(ctas, slice_, on_chip, need if on_chip else 0,
                    THREADS_R2 if r == 2 else THREADS)


def node_slices(n_active: int, plan: ScanPlan) -> List[Tuple[int, int]]:
    """Each CTA's (first node, node count), as the kernel cuts them."""
    out = []
    for rank in range(plan.ctas):
        base = min(rank * plan.slice, n_active)
        out.append((base, min(plan.slice, n_active - base)))
    return out


def place_scan_reference(idle, releasing, task_count, allocatable, pods_limit, mins,
                         init_resreq, resreq, static_mask, static_score, rows,
                         ready_deficit: int, weights: Tuple[float, float, float],
                         enforce_pod_count: bool, n_active: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the inputs' device."""
    dev = idle.device
    t = rows.shape[0]
    n = idle.shape[0]
    out = torch.zeros((3, t), dtype=torch.int32, device=dev)
    out[0] = -1
    if t == 0:
        return out
    in_range = torch.arange(n, device=dev) < n_active
    safe_alloc = torch.where(allocatable > 0, allocatable, 1.0)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    n_alloc = 0
    for k, row in enumerate(rows.tolist()):
        init_req = init_resreq[row]
        fit_idle = fit_mask(init_req, idle, mins)
        fit_rel = fit_mask(init_req, releasing, mins)
        feasible = (fit_idle | fit_rel) & static_mask[row] & in_range
        if enforce_pod_count:
            feasible = feasible & (task_count < pods_limit)
        if not bool(feasible.any()):
            out[2, k] = 1
            break
        req = resreq[row]
        sscore = static_score[row] if static_score is not None else zeros
        score = sscore + dynamic_score(req, idle, allocatable, *weights, safe_alloc=safe_alloc)
        best = int(torch.argmax(torch.where(feasible, score, -torch.inf)))
        alloc_here = bool(fit_idle[best])
        pipe_here = not alloc_here and bool(fit_rel[best])
        if alloc_here:
            idle[best] = idle[best] - req
            n_alloc += 1
        elif pipe_here:
            releasing[best] = releasing[best] - req
        else:
            continue
        task_count[best] += 1
        out[0, k] = best
        out[1, k] = int(pipe_here)
        if n_alloc >= ready_deficit:
            break
    return out


def place_scan(idle: torch.Tensor, releasing: torch.Tensor, task_count: torch.Tensor,
               allocatable: torch.Tensor, pods_limit: torch.Tensor, mins: torch.Tensor,
               init_resreq: torch.Tensor, resreq: torch.Tensor, static_mask: torch.Tensor,
               static_score: Optional[torch.Tensor], rows: torch.Tensor, ready_deficit: int,
               weights: Tuple[float, float, float], enforce_pod_count: bool,
               n_active: Optional[int] = None, plan: Optional[ScanPlan] = None,
               events=None) -> torch.Tensor:
    """Scan the tasks ``rows`` (int32 [t], rows of ``init_resreq`` /
    ``resreq`` f32 [T, R] and of ``static_mask`` bool / ``static_score`` f32
    [T, N]; ``static_score`` None: no static score) over the node state
    ``idle``, ``releasing`` f32 [N, R], ``task_count`` int32 [N] (written in
    place), ``allocatable`` f32 [N, R], ``pods_limit`` int32 [N], ``mins``
    f32 [R].  Returns int32 [3, t]: chosen, pipelined, failed.  On CUDA,
    ``plan`` (default ``scan_plan``'s) is the launch, and ``events`` (a pair
    of ``torch.cuda.Event``) are recorded immediately around it."""
    n, r = idle.shape
    t = rows.shape[0]
    n_t = init_resreq.shape[0]
    n_active = n if n_active is None else int(n_active)
    dev = idle.device
    cuda = dev.type == "cuda"
    tensors = [("idle", idle, torch.float32, (n, r)),
               ("releasing", releasing, torch.float32, (n, r)),
               ("task_count", task_count, torch.int32, (n,)),
               ("allocatable", allocatable, torch.float32, (n, r)),
               ("pods_limit", pods_limit, torch.int32, (n,)),
               ("mins", mins, torch.float32, (r,)),
               ("init_resreq", init_resreq, torch.float32, (n_t, r)),
               ("resreq", resreq, torch.float32, (n_t, r)),
               ("static_mask", static_mask, torch.bool, (n_t, n)),
               ("rows", rows, torch.int32, (t,))]
    if static_score is not None:
        tensors.append(("static_score", static_score, torch.float32, (n_t, n)))
    for name, x, dtype, shape in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
        if cuda and not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if not 0 <= n_active <= n:
        raise ValueError(f"n_active {n_active} outside 0..{n}")
    if dev.type == "cpu":
        return place_scan_reference(idle, releasing, task_count, allocatable, pods_limit, mins,
                                    init_resreq, resreq, static_mask, static_score, rows,
                                    ready_deficit, weights, enforce_pod_count, n_active)
    if not cuda:
        raise ValueError(f"place_scan: no kernel for device {dev}")
    if r < 2 or r > MAX_R:
        raise ValueError(f"place_scan: {r} resource dims outside 2..{MAX_R}")
    if plan is None:
        plan = scan_plan(n_active, r, t, weights, enforce_pod_count)
    return _launch(idle, releasing, task_count, allocatable, pods_limit, mins, init_resreq,
                   resreq, static_mask, static_score, rows, ready_deficit, weights,
                   enforce_pod_count, n_active, plan, events)


_fn = None


def _entry():
    """The kernel's C entry point, its argument types set once."""
    global _fn
    if _fn is None:
        fn = cuda_build.load().place_scan_cluster_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _raw_event(event) -> int:
    """The CUDA event behind a ``torch.cuda.Event`` (created at its first
    record, so a fresh one is recorded once here; the kernel's launch
    records it again)."""
    if not event.cuda_event:
        event.record()
    return event.cuda_event


def _launch(idle, releasing, task_count, allocatable, pods_limit, mins, init_resreq, resreq,
            static_mask, static_score, rows, ready_deficit, weights, enforce_pod_count, n_active,
            plan: ScanPlan, events=None):
    global launches
    if idle.device.type != "cuda":
        raise ValueError(f"place_scan: the kernel takes CUDA tensors, got {idle.device}")
    if plan.ctas * plan.slice < n_active:
        raise ValueError(f"place_scan: {plan} does not cover {n_active} nodes")
    n, r = idle.shape
    t = rows.shape[0]
    fn = _entry()
    out = torch.empty((3, t), dtype=torch.int32, device=idle.device)
    if t == 0:
        out[0] = -1
        out[1:] = 0
        return out
    w_lr, w_bal, w_bp = (float(w) for w in weights)
    ev0, ev1 = (_raw_event(e) for e in events) if events is not None else (None, None)
    stream = torch._C._cuda_getCurrentRawStream(idle.device.index)  # the current stream
    rc = fn(idle.data_ptr(), releasing.data_ptr(), task_count.data_ptr(),
            allocatable.data_ptr(), pods_limit.data_ptr(), mins.data_ptr(),
            init_resreq.data_ptr(), resreq.data_ptr(), static_mask.data_ptr(),
            static_score.data_ptr() if static_score is not None else None,
            rows.data_ptr(), out.data_ptr(), static_mask.stride(0), t, n_active, r,
            int(ready_deficit), int(bool(enforce_pod_count)), w_lr, w_bal, w_bp,
            plan.ctas, plan.threads, plan.slice, int(plan.on_chip), plan.smem_bytes, stream,
            ev0, ev1, None)
    if rc == _ERR_NO_CLUSTER:
        raise RuntimeError(f"place_scan: the card cannot schedule {plan}")
    if rc != 0:
        raise RuntimeError(f"place_scan launch failed: CUDA error {rc} ({plan})")
    launches += 1
    return out
