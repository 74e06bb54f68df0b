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
from typing import Optional, Tuple

import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.predicates import fit_mask
from scheduler_tpu_torch.ops.scoring import dynamic_score

# Launches of the CUDA kernel (the CPU path never counts).
launches = 0

# Resource dims the kernel keeps in shared memory (the vocabulary's width).
MAX_R = 32


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
               n_active: Optional[int] = None) -> torch.Tensor:
    """Scan the tasks ``rows`` (int32 [t], rows of ``init_resreq`` /
    ``resreq`` f32 [T, R] and of ``static_mask`` bool / ``static_score`` f32
    [T, N]; ``static_score`` None: no static score) over the node state
    ``idle``, ``releasing`` f32 [N, R], ``task_count`` int32 [N] (written in
    place), ``allocatable`` f32 [N, R], ``pods_limit`` int32 [N], ``mins``
    f32 [R].  Returns int32 [3, t]: chosen, pipelined, failed."""
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
    return _launch(idle, releasing, task_count, allocatable, pods_limit, mins, init_resreq,
                   resreq, static_mask, static_score, rows, ready_deficit, weights,
                   enforce_pod_count, n_active)


_fn = None


def _entry():
    """The kernel's C entry point, its argument types set once."""
    global _fn
    if _fn is None:
        fn = cuda_build.load().place_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(idle, releasing, task_count, allocatable, pods_limit, mins, init_resreq, resreq,
            static_mask, static_score, rows, ready_deficit, weights, enforce_pod_count, n_active):
    global launches
    if idle.device.type != "cuda":
        raise ValueError(f"place_scan: the kernel takes CUDA tensors, got {idle.device}")
    n, r = idle.shape
    t = rows.shape[0]
    fn = _entry()
    out = torch.empty((3, t), dtype=torch.int32, device=idle.device)
    if t == 0:
        out[0] = -1
        out[1:] = 0
        return out
    w_lr, w_bal, w_bp = (float(w) for w in weights)
    stream = torch._C._cuda_getCurrentRawStream(idle.device.index)  # the current stream
    rc = fn(idle.data_ptr(), releasing.data_ptr(), task_count.data_ptr(),
            allocatable.data_ptr(), pods_limit.data_ptr(), mins.data_ptr(),
            init_resreq.data_ptr(), resreq.data_ptr(), static_mask.data_ptr(),
            static_score.data_ptr() if static_score is not None else None,
            rows.data_ptr(), out.data_ptr(), static_mask.stride(0), t, n_active, r,
            int(ready_deficit), int(bool(enforce_pod_count)), w_lr, w_bal, w_bp, stream)
    if rc != 0:
        raise RuntimeError(f"place_scan launch failed: CUDA error {rc}")
    launches += 1
    return out
