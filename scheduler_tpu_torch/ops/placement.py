"""The placement engine: one job pop's task loop as one kernel launch.

The reference allocates task by task, re-reading node idle state after
every placement (``actions/allocate/allocate.go:95-192``): a sequential
feedback loop that a batched argmax would violate (two tasks double-booking
one node's last slot).  Here that loop is the scan of
``ops/place_scan_kernel.py``: the job's pending tasks in task order,
carrying the idle and releasing matrices and the per-node task counts.
Each step fuses the whole per-task pipeline the reference runs as three
16-goroutine sweeps:

  fit (idle | releasing, epsilon-exact) & static predicate row & pod-count
  -> dynamic node score (least-requested / balanced / binpack from live idle)
  -> argmax -> allocate (idle -= req) or pipeline (releasing -= req)

Reference parity notes (the JAX package's ``ops/placement.py``):

* stop conditions mirror allocate.go: the first task with no feasible node
  stops the job (``failed`` marks it, the host records FitErrors); the
  JobReady break (allocate.go:184-187) is a ``ready_deficit``, the number of
  further *allocations* after which the job becomes gang-ready, checked
  after every placement, so once the deficit is covered (or was already
  <= 0) the next placement of any kind stops the pop;
* SelectBestNode picks uniformly among top scorers
  (scheduler_helper.go:147-158); the engine takes the lowest-index top
  scorer instead;
* pipelined placements don't count toward the ready quota (JobReady counts
  allocated tasks only, job_info.go:367-375).

The JAX scan is functional; here the node state is updated in place (the
engine that owns it, ``ops/allocator.py``, holds its own copies).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops.place_scan_kernel import place_scan


@dataclass
class NodeState:
    """Device-resident node state threaded through placements within one action."""

    idle: torch.Tensor         # f32 [N, R] (device units)
    releasing: torch.Tensor    # f32 [N, R]
    task_count: torch.Tensor   # i32 [N]
    allocatable: torch.Tensor  # f32 [N, R]
    pods_limit: torch.Tensor   # i32 [N]
    mins: torch.Tensor         # f32 [R] scaled epsilon thresholds


@dataclass
class JobPlacementSpec:
    """One job's pending tasks, in task order: rows ``rows`` of the
    session's request and static tensors."""

    init_resreq: torch.Tensor  # f32 [T, R] fit requests (InitResreq)
    resreq: torch.Tensor       # f32 [T, R] accounting requests (Resreq)
    static_mask: torch.Tensor  # bool [T, N] session-static predicates per task
    static_score: Optional[torch.Tensor]  # f32 [T, N] static score (None: 0)
    rows: torch.Tensor         # i32 [t] the pop's rows of the tensors above
    ready_deficit: int         # allocations still needed for readiness
    n_active: Optional[int] = None  # real nodes (the rest are pad columns; None: all)


@dataclass
class PlacementResult:
    chosen: np.ndarray     # i32 [t] node index or -1
    pipelined: np.ndarray  # bool [t]
    failed: np.ndarray     # bool [t] first infeasible task (host records FitErrors)
    wrapper_s: float = 0.0  # host seconds in the scan's wrapper (the launch included)


def _place_scan(idle, releasing, task_count, allocatable, pods_limit, mins, init_resreq,
                resreq, static_mask, static_score, valid, ready_deficit,
                weights: Tuple[float, float, float], enforce_pod_count: bool):
    """The JAX function's signature and result, functional: the scan over
    the rows of the tensors where ``valid`` (bool [T]; the JAX layout pads a
    pop with invalid rows, which place and stop nothing), on copies of the
    node state.  Returns ``(idle, releasing, task_count, chosen, pipelined,
    failed)``, each task's result at its row."""
    idle, releasing, task_count = idle.clone(), releasing.clone(), task_count.clone()
    rows = torch.nonzero(valid).flatten().to(torch.int32)
    codes = place_scan(idle, releasing, task_count, allocatable, pods_limit, mins,
                       init_resreq, resreq, static_mask, static_score, rows,
                       int(ready_deficit), weights, enforce_pod_count)
    padded = torch.zeros((3, valid.shape[0]), dtype=torch.int32, device=idle.device)
    padded[0] = -1
    padded[:, rows.long()] = codes
    return idle, releasing, task_count, padded[0], padded[1].bool(), padded[2].bool()


def sequential_place_job(
    state: NodeState,
    spec: JobPlacementSpec,
    weights: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    enforce_pod_count: bool = False,
    events=None,
) -> Tuple[NodeState, PlacementResult]:
    """Place one job's tasks sequentially on the state's device, updating
    ``state`` in place (one launch of the scan kernel on CUDA, its plain
    version on the CPU); returns the state and the pop's result.

    ``weights`` = (least_requested, balanced_allocation, binpack) scorer
    weights; a weight of 0 leaves its scorer out.  ``events`` (a pair of
    CUDA events) are recorded immediately around the kernel's launch."""
    t0 = time.perf_counter()
    codes = place_scan(state.idle, state.releasing, state.task_count, state.allocatable,
                       state.pods_limit, state.mins, spec.init_resreq, spec.resreq,
                       spec.static_mask, spec.static_score, spec.rows,
                       int(spec.ready_deficit), weights, enforce_pod_count, spec.n_active,
                       events=events)
    wrapper_s = time.perf_counter() - t0
    host = codes.cpu().numpy()
    return state, PlacementResult(chosen=host[0], pipelined=host[1].astype(bool),
                                  failed=host[2].astype(bool), wrapper_s=wrapper_s)
