"""The XLA step arm of the ``fused_allocate`` loop: one step's selection,
batch sizing and node-row update as ONE CUDA launch.

The JAX loop (``scheduler_tpu/ops/fused.py:175-1030``) takes this arm where
the placement-step kernel is gated off: the session has releasing capacity
(the pipeline arm needs each node's idle and releasing fit), the top-2
score bound is live (runs batch under scorers other than binpack alone:
the bound needs the whole masked score vector), or the node state
outgrows the kernel's budget.  There it is XLA code inside the loop's one
device program (``fused.py:704-864``); here it is the hand-written kernel
``csrc/xla_step.cu``, built with the port's other kernels at first use
(``ops/cuda_build.py``) and bound through plain C entry points with
``ctypes``.  A step computes:

* the epsilon fit ``init < avail | |avail - init| < min`` on every dim,
  against idle alone or jointly against idle and releasing
  (``fused.py:704-725``), the node gate, the static mask row and the pod
  count (``:726-731``);
* ``ops/scoring.py::dynamic_score`` plus the static score row, the masked
  lowest-index argmax and the winner's feasibility (``:732-743``);
* the alloc / pipe split at the winner (``:745-753``);
* with run batching, the batch size: the ``MAX_BATCH`` candidate grid of
  sequential fits on the winner and, under the score bound, the runner-up
  (``others``, ``second``, ``second_idx``) and the grid's scores against it
  with a running product (``:757-833``);
* the winner's node-row add, ``-req * (alloc * m)`` on idle, ``-req *
  pipe`` on releasing, the placed copies on the task count (``:846-864``).

The node state ``[N, 2R + 1]`` (idle | releasing | task count) stays on
the device for the whole loop, and the kernel adds the winner's row in
place.  Everything else of the loop (job and queue selection, the job
ledger, the codes) is the host's (``ops/fused.py``).

* ``XlaStep`` — the arm bound for one loop.  On CUDA operands each
  ``step`` is one C call: one launch (the task's rows in its parameters)
  and a wait; the kernel writes its five results to mapped pinned host
  memory.  Each launch adds one to ``launches``.  CUDA events recorded by
  the entry point around each launch are summed into ``xla_ms``, the host
  clock around each step into ``host_ms`` (both None on the CPU).  On CPU operands, or with
  ``plain``, each step is ``xla_step_reference``.
* ``xla_step_reference`` — the plain PyTorch version: the JAX arm's
  operations in its order, each one PyTorch operation, and one readback.
* ``XlaShardStep`` — the arm over a node mesh (``ops/mesh.py``): one
  launch of ``xla_shard_kernel`` a shard a step, each writing its block's
  candidate (winner, fits, pod room, runner-up, batch grid), merged on the
  host by ``merge_shard_candidates`` to the one-device result; plain
  version ``xla_shard_reference``.
* ``step_plan`` — the kernel's launch plan: one CTA of up to 1,024
  threads, a node a thread where the node count fits and strided over the
  nodes past that, so any node count (past the placement-step kernel's
  65,536-node budget too) and any resource dim count.  A plan the card
  cannot run makes the arm raise; nothing falls back.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.scoring import dynamic_score

# Upper bound on placements a step (``ops/fused.py`` MAX_BATCH).
MAX_BATCH = 128

# Launches of the CUDA kernel (the CPU path and the plain version never count).
launches = 0

# The kernel's limits (csrc/xla_step.cu): threads of its one CTA (the
# candidate grid needs MAX_BATCH of them).
THREADS = 1024
MIN_THREADS = 128


@dataclass(frozen=True)
class StepPlan:
    """A launch of the kernel: one CTA of ``threads`` threads, each taking
    every ``threads``-th node, ``strides`` nodes at most."""

    threads: int
    strides: int

    def describe(self) -> dict:
        return {"threads": self.threads, "strides": self.strides}


def step_plan(n: int, threads: Optional[int] = None) -> StepPlan:
    """The plan for ``n`` nodes: by default ``n`` threads rounded up to a
    warp (at least ``MIN_THREADS``, at most ``THREADS``, strided past
    that); ``threads`` forces the thread count."""
    if n < 1:
        raise ValueError(f"xla_step: {n} nodes (at least 1)")
    if threads is None:
        threads = THREADS if n >= THREADS else max(MIN_THREADS, -(-n // 32) * 32)
    if threads % 32 or not MIN_THREADS <= threads <= THREADS:
        raise ValueError(f"xla_step: {threads} threads a CTA (a multiple of 32 in "
                         f"{MIN_THREADS}..{THREADS})")
    return StepPlan(threads, -(-n // threads))


# -- the plain PyTorch version ---------------------------------------------------

class PlainConsts(NamedTuple):
    """The plain version's loop-invariant tensors, made once an arm."""

    safe_alloc: torch.Tensor
    pods_limit_f: torch.Tensor
    lanes: torch.Tensor
    js: torch.Tensor
    js_f: torch.Tensor
    neg_inf: torch.Tensor
    false: torch.Tensor
    one: torch.Tensor


def plain_consts(allocatable: torch.Tensor, pods_limit: torch.Tensor) -> PlainConsts:
    dev = allocatable.device
    js = torch.arange(1, MAX_BATCH + 1, dtype=torch.int32, device=dev)
    return PlainConsts(
        torch.where(allocatable > 0, allocatable, 1.0), pods_limit.to(torch.float32),
        torch.arange(allocatable.shape[0], device=dev), js, (js - 1).to(torch.float32),
        torch.tensor(float("-inf"), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.ones((), dtype=torch.int32, device=dev))


def _fit(init_req, avail, mins):
    """The epsilon fit of ``init_req`` [R] against avail [..., R] on every
    dim (``scheduler_tpu/ops/predicates.py:20-27``)."""
    return ((init_req < avail) | ((avail - init_req).abs() < mins)).all(dim=-1)


def xla_step_reference(node_state, allocatable, pods_limit, node_gate, mins, init_resreq,
                       resreq, static_mask, static_score, t_idx: int, s_idx: int, hi0: int,
                       **kw):
    """One step in plain PyTorch on the operands' device: task row
    ``t_idx``, static row ``s_idx``, the host's batch cap ``hi0`` (read only
    with ``batch_runs``; a cap of 1 places one copy without the grid).
    Adds the winner's row to ``node_state`` in place and returns ``(best,
    feasible, alloc_here, pipe_here, m)`` as Python values (one readback).
    Keywords: the arm's flags (``weights``, ``use_static``,
    ``enforce_pod_count``, ``has_releasing``, ``batch_runs``,
    ``score_bound``), ``consts`` (``plain_consts``, made once an arm) and
    ``detail``, a dict that receives the step's intermediates (``masked``,
    ``second``, ``second_idx``, ``ok_js``, ``ok_s``, ``hi``, ``fit_count``)
    for the tests' planted cases."""
    packed = step_tensors(node_state, allocatable, pods_limit, node_gate, mins, init_resreq,
                          resreq, static_mask, static_score, t_idx, s_idx, hi0, **kw)
    best_i, ok, alloc_i, pipe_i, m_i = packed.tolist()
    return best_i, bool(ok), bool(alloc_i), bool(pipe_i), m_i


def step_tensors(node_state, allocatable, pods_limit, node_gate, mins, init_resreq, resreq,
                 static_mask, static_score, t_idx: int, s_idx: int, hi0: int, *, weights,
                 use_static, enforce_pod_count, has_releasing, batch_runs, score_bound,
                 consts: Optional[PlainConsts] = None, detail: Optional[dict] = None):
    """``xla_step_reference``'s device work: the five results packed in an
    int32 [5] tensor on the operands' device, not read back."""
    c = consts if consts is not None else plain_consts(allocatable, pods_limit)
    weights = tuple(float(w) for w in weights)
    r_dim = allocatable.shape[1]
    ns = node_state
    init_req, req = init_resreq[t_idx], resreq[t_idx]
    idle = ns[:, :r_dim]
    if has_releasing:
        # Joint fit against idle and releasing in one op chain.
        avail2 = ns[:, : 2 * r_dim].reshape(-1, 2, r_dim)
        ok2 = _fit(init_req, avail2, mins)
        fit_idle, fit_rel = ok2[:, 0], ok2[:, 1]
        feasible = (fit_idle | fit_rel) & node_gate
    else:
        fit_idle = fit_rel = None
        feasible = _fit(init_req, idle, mins) & node_gate
    if use_static:
        feasible = feasible & static_mask[s_idx]
    if enforce_pod_count:
        feasible = feasible & (ns[:, 2 * r_dim] < c.pods_limit_f)
    score = dynamic_score(req, idle, allocatable, *weights, safe_alloc=c.safe_alloc)
    if use_static:
        score = score + static_score[s_idx]
    masked = torch.where(feasible, score, c.neg_inf)
    best = torch.argmax(masked)
    any_feasible = masked[best] > c.neg_inf
    if has_releasing:
        alloc_here = any_feasible & fit_idle[best]
        pipe_here = any_feasible & ~fit_idle[best] & fit_rel[best]
    else:
        alloc_here = any_feasible
        pipe_here = c.false
    if detail is not None:
        others = torch.where(c.lanes == best, c.neg_inf, masked)
        detail.update(masked=masked, second=float(others.max()),
                      second_idx=int(torch.argmax(others)))
    if batch_runs and hi0 > 1:
        # (With a host cap of 1 the grid's answer is 1 whatever it holds:
        # the batch block is skipped.)
        if enforce_pod_count:
            tc_best = ns[best, 2 * r_dim]
            room = pods_limit[best] - tc_best.to(torch.int32)
            hi = torch.clamp(torch.clamp(room, max=hi0), min=1)
        else:
            hi = max(hi0, 1)
        idle_b = idle[best]
        avail = idle_b[None, :] - c.js_f[:, None] * req[None, :]
        ok_js = _fit(init_req, avail, mins)
        if detail is not None:
            detail["ok_js"] = ok_js.tolist()
        if score_bound:
            # Top-2 bound: placement j still picks best while its score
            # after j - 1 placements beats the runner-up (lowest index on
            # ties); a prefix, since non-binpack scores are not monotone.
            others = torch.where(c.lanes == best, c.neg_inf, masked)
            second = others.max()
            second_idx = torch.argmax(others)
            alloc_b = allocatable[best][None, :].expand(MAX_BATCH, r_dim)
            safe_b = c.safe_alloc[best][None, :].expand(MAX_BATCH, r_dim)
            s_js = dynamic_score(req, avail, alloc_b, *weights, safe_alloc=safe_b)
            if use_static:
                s_js = s_js + static_score[s_idx, best]
            ok_s = (s_js > second) | ((s_js == second) & (best < second_idx))
            if detail is not None:
                detail["ok_s"] = ok_s.tolist()
            ok_js = ok_js & (torch.cumprod(ok_s.to(torch.int32), 0, dtype=torch.int32) > 0)
        fit_count = torch.where(ok_js & (c.js <= hi), c.js, 1).max()
        if detail is not None:
            detail.update(hi=int(hi), fit_count=int(fit_count))
        m = torch.where(alloc_here, fit_count, 1).to(torch.int32)
    else:
        m = c.one
    # The winner's node row: idle -= req * m if allocated, releasing -=
    # req if pipelined, task count += the copies placed.
    m_f = m.to(torch.float32)
    copies = torch.where(alloc_here, m, 1)
    row = torch.cat([
        -req * (alloc_here * m_f),
        -req * pipe_here,
        ((alloc_here | pipe_here) * copies).to(torch.float32)[None],
    ])
    ns.index_add_(0, best.reshape(1), row[None, :])
    return torch.stack([best.to(torch.int32), any_feasible.to(torch.int32),
                        alloc_here.to(torch.int32), pipe_here.to(torch.int32), m])


# -- bind ------------------------------------------------------------------------

class XlaStepParams(ctypes.Structure):
    """Mirror of ``struct XlaStepParams`` in ``csrc/xla_step.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("ns", "alloc", "plim", "gate", "smask", "sscore", "initq", "req", "mins",
                     "out")
    ] + [
        (name, ctypes.c_int)
        for name in ("n", "r", "cpu_idx", "mem_idx", "use_static", "enforce_pod_count",
                     "has_releasing", "batch_runs", "score_bound", "hi0")
    ] + [(name, ctypes.c_float) for name in ("w_lr", "w_bal", "w_bp")]


class XlaLoop(ctypes.Structure):
    """Mirror of ``struct XlaLoop`` in ``csrc/xla_step.cu``."""

    _fields_ = [
        ("p", XlaStepParams),
        ("out_host", ctypes.c_void_p),
        ("ev0", ctypes.c_void_p),
        ("ev1", ctypes.c_void_p),
        ("xla_ms", ctypes.c_double),
        ("steps", ctypes.c_longlong),
        ("s_stride", ctypes.c_longlong),
        ("t_rows", ctypes.c_int),
        ("s_rows", ctypes.c_int),
        ("threads", ctypes.c_int),
    ]


_lib = None


def _library():
    """The port's CUDA library, with the argument types of this kernel's
    entry points set once."""
    global _lib
    if _lib is None:
        lib = cuda_build.load()
        for name in ("xla_step_loop_begin", "xla_step_loop_end", "xla_step_loop_step",
                     "xla_step_loop_size"):
            getattr(lib, name).restype = ctypes.c_int
        lib.xla_step_loop_begin.argtypes = [ctypes.c_void_p]
        lib.xla_step_loop_end.argtypes = [ctypes.c_void_p]
        lib.xla_step_loop_step.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
        lib.xla_step_loop_size.argtypes = []
        if lib.xla_step_loop_size() != ctypes.sizeof(XlaLoop):
            raise RuntimeError("xla_step: the library's XlaLoop differs from the wrapper's")
        _lib = lib
    return _lib


# -- the arm -----------------------------------------------------------------------

class XlaStep:
    """The arm bound for one loop: the node state staged on ``allocatable``'s
    device from the host's ``idle`` / ``releasing`` / ``task_count``; the
    other operands are the loop's device tensors (``static_mask`` /
    ``static_score`` [S, N] rows, read at the row the caller names).

    ``step(t_idx, s_idx, hi0)`` runs one step for task row ``t_idx`` with
    static row ``s_idx`` and the host's batch cap ``hi0`` (the run length,
    ``MAX_BATCH`` and the gang room; read only with ``batch_runs``, and a
    cap of 1 places one copy without the candidate grid) and
    returns ``(best, feasible, alloc_here, pipe_here, m)`` as Python
    values, after adding the winner's row to the node state.

    On CUDA operands the step is the kernel (``plan``: default
    ``step_plan``'s), or raises; with ``plain`` it is the plain version on
    the card.  With ``check_every`` > 0 the kernel is held to the plain
    version, run first on a clone of the node state, at the first step and
    every ``check_every``-th one (the five results and the whole node
    state, bitwise; ``checked`` counts them); a disagreement raises."""

    def __init__(self, idle, releasing, task_count, allocatable, pods_limit, node_gate, mins,
                 init_resreq, resreq, static_mask, static_score, *, weights, use_static,
                 enforce_pod_count, has_releasing, batch_runs, score_bound, plain=False,
                 check_every=0, plan: Optional[StepPlan] = None):
        dev = allocatable.device
        f32 = torch.float32
        self.device = dev
        n, r_dim = allocatable.shape
        self.n, self.r_dim = n, r_dim
        self.node_state = torch.cat([
            torch.as_tensor(idle, dtype=f32).reshape(n, r_dim),
            torch.as_tensor(releasing, dtype=f32).reshape(n, r_dim),
            torch.as_tensor(task_count).to(f32).reshape(n, 1),
        ], dim=1).to(dev).contiguous()
        self.allocatable = allocatable
        self.pods_limit = pods_limit
        self.node_gate = node_gate
        self.mins = mins
        self.init_resreq, self.resreq = init_resreq, resreq
        self.static_mask, self.static_score = static_mask, static_score
        self.flags = dict(weights=tuple(float(w) for w in weights), use_static=use_static,
                          enforce_pod_count=enforce_pod_count, has_releasing=has_releasing,
                          batch_runs=batch_runs, score_bound=score_bound)
        self.consts = plain_consts(allocatable, pods_limit)
        self.cuda = dev.type == "cuda"
        self.kernel = self.cuda and not plain
        self.check_every = check_every if self.kernel else 0
        self.checked = 0
        self.xla_ms = 0.0 if self.cuda else None
        self.host_ms = 0.0 if self.cuda else None
        self.steps = 0
        self.plan = None
        self._addr = None
        if self.kernel:
            self.plan = plan or step_plan(n)
            self._bind()
        elif self.cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))

    def _bind(self) -> None:
        n, r_dim, plan = self.n, self.r_dim, self.plan
        if r_dim < 2:
            raise ValueError(f"xla_step: {r_dim} resource dims (cpu and memory at least)")
        f32 = torch.float32
        t_rows = self.resreq.shape[0]
        for name, t, dtype, shape in (
            ("allocatable", self.allocatable, f32, (n, r_dim)),
            ("pods_limit", self.pods_limit, torch.int32, (n,)),
            ("node_gate", self.node_gate, torch.bool, (n,)),
            ("mins", self.mins, f32, (r_dim,)),
            ("init_resreq", self.init_resreq, f32, (t_rows, r_dim)),
            ("resreq", self.resreq, f32, (t_rows, r_dim)),
        ):
            if t.device != self.device or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"xla_step: {name} must be a {dtype} tensor of shape {shape} "
                                 f"on {self.device}")
        use_static = self.flags["use_static"]
        if use_static and (self.static_mask.shape[1] != n or self.static_score.shape[1] != n
                           or self.static_mask.shape[0] != self.static_score.shape[0]
                           or self.static_mask.dtype != torch.bool
                           or self.static_score.dtype != f32):
            raise ValueError("xla_step: static rows must be bool / float32 [S, N]")
        # The kernel reads these in place: contiguous copies where they are not.
        for name in ("allocatable", "pods_limit", "node_gate", "mins", "init_resreq", "resreq",
                     "static_mask", "static_score"):
            setattr(self, name, getattr(self, name).contiguous())
        self._lib = _library()
        args = XlaLoop()
        p = args.p
        p.ns, p.alloc, p.plim, p.gate = (self.node_state.data_ptr(), self.allocatable.data_ptr(),
                                         self.pods_limit.data_ptr(), self.node_gate.data_ptr())
        p.smask, p.sscore = self.static_mask.data_ptr(), self.static_score.data_ptr()
        p.initq, p.req, p.mins = (self.init_resreq.data_ptr(), self.resreq.data_ptr(),
                                  self.mins.data_ptr())
        p.n, p.r = n, r_dim
        p.cpu_idx, p.mem_idx = 0, 1  # api/vocab.py CPU, MEMORY
        for key in ("use_static", "enforce_pod_count", "has_releasing", "batch_runs",
                    "score_bound"):
            setattr(p, key, int(bool(self.flags[key])))
        p.w_lr, p.w_bal, p.w_bp = self.flags["weights"]
        args.s_stride = n
        args.t_rows = t_rows
        args.s_rows = self.static_mask.shape[0] if use_static else 0
        args.threads = plan.threads
        self._args = args
        self._addr = ctypes.addressof(args)
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.xla_step_loop_begin(self._addr)
        if rc != 0:
            self._lib.xla_step_loop_end(self._addr)
            self._addr = None
            raise RuntimeError(f"xla_step: plan, mapped result or event setup failed: "
                               f"CUDA error {rc} ({plan})")
        # The kernel's five results, in mapped pinned host memory.
        self._res = (ctypes.c_int32 * 8).from_address(args.out_host)

    def plain_step(self, node_state, t_idx: int, s_idx: int, hi0: int, detail=None):
        """The plain version of one step on ``node_state`` (this arm's, or
        a clone of it), with the arm's other operands."""
        return xla_step_reference(node_state, self.allocatable, self.pods_limit, self.node_gate,
                                  self.mins, self.init_resreq, self.resreq, self.static_mask,
                                  self.static_score, t_idx, s_idx, hi0, consts=self.consts,
                                  detail=detail, **self.flags)

    def step(self, t_idx: int, s_idx: int, hi0: int):
        global launches
        self.steps += 1
        if not self.kernel:
            t0 = time.perf_counter()
            if self.cuda:
                self._ev[0].record()
            packed = step_tensors(self.node_state, self.allocatable, self.pods_limit,
                                  self.node_gate, self.mins, self.init_resreq, self.resreq,
                                  self.static_mask, self.static_score, t_idx, s_idx, hi0,
                                  consts=self.consts, **self.flags)
            if self.cuda:
                self._ev[1].record()
            best_i, ok, alloc_i, pipe_i, m_i = packed.tolist()
            if self.cuda:
                self.xla_ms += self._ev[0].elapsed_time(self._ev[1])
                self.host_ms += 1e3 * (time.perf_counter() - t0)
            return best_i, bool(ok), bool(alloc_i), bool(pipe_i), m_i
        check = self.check_every and (self.steps - 1) % self.check_every == 0
        if check:
            twin = self.node_state.clone()
            want = self.plain_step(twin, t_idx, s_idx, hi0)
        t0 = time.perf_counter()
        rc = self._lib.xla_step_loop_step(self._addr, t_idx,
                                          s_idx if self.flags["use_static"] else 0, hi0,
                                          self._stream)
        if rc != 0:
            raise RuntimeError(f"xla_step launch failed: CUDA error {rc} ({self.plan})")
        launches += 1
        res = self._res
        result = res[0], res[1] != 0, res[2] != 0, res[3] != 0, res[4]
        self.host_ms += 1e3 * (time.perf_counter() - t0)
        if check:
            self.checked += 1
            same_state = torch.equal(self.node_state.view(torch.int32), twin.view(torch.int32))
            if result != want or not same_state:
                raise RuntimeError(f"xla_step: kernel {result} != plain {want} (node state "
                                   f"equal: {same_state}) at loop step {self.steps}, task row "
                                   f"{t_idx}")
        return result

    def close(self) -> None:
        """Release the events and the mapped result; keep the kernel's
        summed time."""
        if self._addr is not None:
            self._res = None
            rc = self._lib.xla_step_loop_end(self._addr)
            self.xla_ms = float(self._args.xla_ms)
            self._addr = None
            if rc != 0:
                raise RuntimeError(f"xla_step: CUDA error {rc}")


# -- shard mode: the arm over a node mesh ----------------------------------------
#
# The JAX loop's XLA arm runs under GSPMD over the sharded node ledger
# (scheduler_tpu/ops/fused.py:683-700): one program, the argmax and the
# top-2 bound reduced across shards.  Here each shard's block is one launch
# of ``xla_shard_kernel`` a step (``csrc/xla_step.cu``), writing a
# candidate; the host merges the D candidates with compares only
# (``merge_shard_candidates``), so the result is bitwise the one-device
# step's, and the winner's row add rides the owning shard's next launch.

# Launches of the shard-mode kernel (the CPU path and the plain version never count).
shard_launches = 0


class SHARD_CAND:
    """Words of a shard's candidate (``csrc/xla_step.cu`` XC_*), int32 with
    the float32 ones as their bits."""

    BEST = 0         # the block's winner, as a global index
    SCORE = 1        # its masked score (f32)
    FIT_IDLE = 2
    FIT_REL = 3
    SECOND = 4       # the block's runner-up score (f32)
    SECOND_IDX = 5   # its global index (BIG_I32 where the block has one node)
    ROOM = 6         # pod room at the winner: pods limit - int(task count)
    GRID = 7         # 1 where the batch grid was computed
    FITS = 8         # span 4: bit j - 1 is candidate j's epsilon fit
    S = 12           # span 128: candidate j's grid score (f32; 0 without the bound)
    WORDS = 144


BIG_I32 = 2**31 - 1


class ShardCandidate(NamedTuple):
    best: int
    score: float
    fit_idle: bool
    fit_rel: bool
    second: float
    second_idx: int
    room: int
    grid: bool
    fits: int                    # bit j - 1: candidate j fits (0 without the grid)
    s: Optional[np.ndarray]      # float32 [128] grid scores (None without the grid)


def same_candidate(a: ShardCandidate, b: ShardCandidate) -> bool:
    """Two candidates equal, the float32 fields and grid scores bitwise."""
    f32 = np.float32
    return (a.best == b.best and a.fit_idle == b.fit_idle and a.fit_rel == b.fit_rel
            and a.second_idx == b.second_idx and a.room == b.room and a.grid == b.grid
            and f32(a.score).tobytes() == f32(b.score).tobytes()
            and f32(a.second).tobytes() == f32(b.second).tobytes()
            and a.fits == b.fits and (a.s is None) == (b.s is None)
            and (a.s is None or a.s.tobytes() == b.s.tobytes()))


def _better(v: float, i: int, bv: float, bi: int) -> bool:
    return v > bv or (v == bv and i < bi)


def merge_shard_candidates(cands, hi0: int, *, has_releasing: bool, batch_runs: bool,
                           score_bound: bool, enforce_pod_count: bool):
    """The D shards' candidates -> the step's ``(best, feasible,
    alloc_here, pipe_here, m)``, as ``xla_step_kernel`` computes them over
    the whole axis: the winner the largest score at the lowest global index
    (the first shard on ties), the runner-up the best of the other shards'
    winners and the winning shard's runner-up (its index 0 where it is
    -inf), the cap from the winner's pod room, the count from the winning
    shard's grid against that runner-up.  Compares only."""
    w = 0
    for k in range(1, len(cands)):
        if _better(cands[k].score, cands[k].best, cands[w].score, cands[w].best):
            w = k
    c = cands[w]
    feasible = c.score > float("-inf")
    alloc_here = feasible and (c.fit_idle or not has_releasing)
    pipe_here = has_releasing and feasible and not c.fit_idle and c.fit_rel
    m = 1
    if batch_runs and hi0 > 1 and alloc_here:
        hi = hi0
        if enforce_pod_count:
            hi = max(min(c.room, hi0), 1)
        first_cut = MAX_BATCH
        if score_bound:
            sv, si = c.second, c.second_idx
            for k, o in enumerate(cands):
                if k != w and _better(o.score, o.best, sv, si):
                    sv, si = o.score, o.best
            if not sv > float("-inf"):
                si = 0
            sv = np.float32(sv)
            ok = (c.s > sv) | ((c.s == sv) & (c.best < si))
            if not ok.all():
                first_cut = int(np.argmin(ok))
        # The largest j <= min(hi, first_cut) whose candidate fits (1 where none).
        m = max((c.fits & ((1 << min(hi, first_cut)) - 1)).bit_length(), 1)
    return c.best, feasible, alloc_here, pipe_here, m


def xla_shard_reference(node_state, allocatable, pods_limit, node_gate, mins, init_resreq,
                        resreq, static_mask, static_score, t_idx: int, s_idx: int, hi0: int,
                        *, offset: int, push=None, scan: bool = True, weights, use_static,
                        enforce_pod_count, has_releasing, batch_runs, score_bound,
                        consts: Optional[PlainConsts] = None):
    """The shard-mode kernel's function in plain PyTorch on one block:
    ``push`` ``(row, task row, m, alloc, pipe)`` or None is the row add the
    launch applies first (in place on ``node_state``); then, with ``scan``,
    the block's ``ShardCandidate`` (``offset``: the block's first global
    index)."""
    c = consts if consts is not None else plain_consts(allocatable, pods_limit)
    weights = tuple(float(w) for w in weights)
    r_dim = allocatable.shape[1]
    n = allocatable.shape[0]
    ns = node_state
    if push is not None:
        row, pt, pm, pa, pp = push
        req_p = resreq[pt]
        delta = torch.cat([
            -req_p * (np.float32(pm) if pa else np.float32(0.0)),
            -req_p * (np.float32(1.0) if pp else np.float32(0.0)),
            torch.tensor([float(pm if pa else 1) if (pa or pp) else 0.0],
                         dtype=torch.float32, device=ns.device),
        ])
        ns.index_add_(0, torch.tensor([row], device=ns.device), delta[None, :])
    if not scan:
        return None
    init_req, req = init_resreq[t_idx], resreq[t_idx]
    idle = ns[:, :r_dim]
    avail2 = ns[:, : 2 * r_dim].reshape(-1, 2, r_dim)
    ok2 = _fit(init_req, avail2, mins)
    fit_idle, fit_rel = ok2[:, 0], ok2[:, 1]
    feasible = ((fit_idle | fit_rel) if has_releasing else fit_idle) & node_gate
    if use_static:
        feasible = feasible & static_mask[s_idx]
    if enforce_pod_count:
        feasible = feasible & (ns[:, 2 * r_dim] < c.pods_limit_f)
    score = dynamic_score(req, idle, allocatable, *weights, safe_alloc=c.safe_alloc)
    if use_static:
        score = score + static_score[s_idx]
    masked = torch.where(feasible, score, c.neg_inf)
    best = int(torch.argmax(masked))
    others = torch.where(c.lanes == best, c.neg_inf, masked)
    second = float(others.max()) if n > 1 else float("-inf")
    if second > float("-inf"):
        second_idx = int(torch.argmax(others)) + offset
    elif n > 1:
        second_idx = (0 if best != 0 else 1) + offset
    else:
        second_idx = BIG_I32
    v1 = float(masked[best])
    fi, fr = bool(fit_idle[best]), bool(fit_rel[best])
    room = int(pods_limit[best]) - int(ns[best, 2 * r_dim].to(torch.int32))
    al = v1 > float("-inf") and (fi or not has_releasing)
    grid = bool(batch_runs and hi0 > 1 and al)
    fits, s = 0, None
    if grid:
        idle_b = idle[best]
        avail = idle_b[None, :] - c.js_f[:, None] * req[None, :]
        bits = _fit(init_req, avail, mins).cpu().numpy()
        fits = int.from_bytes(np.packbits(bits, bitorder="little").tobytes(), "little")
        if score_bound:
            alloc_b = allocatable[best][None, :].expand(MAX_BATCH, r_dim)
            safe_b = c.safe_alloc[best][None, :].expand(MAX_BATCH, r_dim)
            s_js = dynamic_score(req, avail, alloc_b, *weights, safe_alloc=safe_b)
            if use_static:
                s_js = s_js + static_score[s_idx, best]
            s = s_js.cpu().numpy().astype(np.float32)
        else:
            s = np.zeros(MAX_BATCH, np.float32)
    return ShardCandidate(best + offset, v1, fi, fr, second, second_idx, room, grid, fits, s)


class XlaShardParams(ctypes.Structure):
    """Mirror of ``struct XlaShardParams`` in ``csrc/xla_step.cu``."""

    _fields_ = [("p", XlaStepParams), ("push_req", ctypes.c_void_p)] + [
        (name, ctypes.c_int)
        for name in ("push_row", "push_m", "push_alloc", "push_pipe", "scan", "offset")
    ]


class XlaShardLoop(ctypes.Structure):
    """Mirror of ``struct XlaShardLoop`` in ``csrc/xla_step.cu``."""

    _fields_ = [
        ("q", XlaShardParams),
        ("out_host", ctypes.c_void_p),
        ("ev0", ctypes.c_void_p),
        ("ev1", ctypes.c_void_p),
        ("xla_ms", ctypes.c_double),
        ("steps", ctypes.c_longlong),
        ("s_stride", ctypes.c_longlong),
        ("t_rows", ctypes.c_int),
        ("s_rows", ctypes.c_int),
        ("threads", ctypes.c_int),
    ]


_shard_lib = None


def _shard_library():
    global _shard_lib
    if _shard_lib is None:
        lib = cuda_build.load()
        for name in ("xla_shard_loop_begin", "xla_shard_loop_end", "xla_shard_loop_launch",
                     "xla_shard_loop_wait", "xla_shard_loop_size"):
            getattr(lib, name).restype = ctypes.c_int
        lib.xla_shard_loop_begin.argtypes = [ctypes.c_void_p]
        lib.xla_shard_loop_end.argtypes = [ctypes.c_void_p]
        lib.xla_shard_loop_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.xla_shard_loop_wait.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.xla_shard_loop_size.argtypes = []
        if lib.xla_shard_loop_size() != ctypes.sizeof(XlaShardLoop):
            raise RuntimeError("xla_step: the library's XlaShardLoop differs from the wrapper's")
        _shard_lib = lib
    return _shard_lib


def _decode(words) -> ShardCandidate:
    """A candidate from its int32 words (a numpy int32 array it may keep)."""
    f = words.view(np.float32)
    grid = bool(words[SHARD_CAND.GRID])
    fits, s = 0, None
    if grid:
        fits = int.from_bytes(words[SHARD_CAND.FITS:SHARD_CAND.FITS + 4].tobytes(), "little")
        s = f[SHARD_CAND.S:SHARD_CAND.S + MAX_BATCH]
    return ShardCandidate(int(words[SHARD_CAND.BEST]), float(f[SHARD_CAND.SCORE]),
                          bool(words[SHARD_CAND.FIT_IDLE]), bool(words[SHARD_CAND.FIT_REL]),
                          float(f[SHARD_CAND.SECOND]), int(words[SHARD_CAND.SECOND_IDX]),
                          int(words[SHARD_CAND.ROOM]), grid, fits, s)


class _Shard:
    """One block's operands, node state and (on CUDA) bound kernel loop."""

    def __init__(self, k, dev, node_state, allocatable, pods_limit, node_gate, mins,
                 init_resreq, resreq, static_mask, static_score, offset):
        self.k, self.device, self.offset = k, dev, offset
        self.node_state = node_state
        self.allocatable, self.pods_limit, self.node_gate = allocatable, pods_limit, node_gate
        self.mins, self.init_resreq, self.resreq = mins, init_resreq, resreq
        self.static_mask, self.static_score = static_mask, static_score
        self.consts = plain_consts(allocatable, pods_limit)
        self.addr = None


class XlaShardStep:
    """The XLA arm over a node mesh: ``XlaStep``'s ``step(t_idx, s_idx,
    hi0)`` with the node axis split into ``mesh.size`` blocks.

    ``allocatable``, ``pods_limit``, ``node_gate`` and (with ``use_static``)
    ``static_mask`` / ``static_score`` come as ``ops/mesh.py`` Sharded
    blocks; ``idle``, ``releasing``, ``task_count`` are the host's whole
    arrays, staged block by block on the shards' devices; ``mins`` and the
    request rows are copied to each shard's device.  A step launches every
    shard (``shard_launches`` + 1 each), waits, merges the candidates
    (``merge_shard_candidates``) and keeps the winner's row add for the
    owning shard's next launch (``flush`` applies a pending one).  On CPU
    blocks, or with ``plain``, each launch is ``xla_shard_reference``.
    ``check_every`` holds each shard's kernel to its plain version, on a
    clone of the block's node state, at the first step and every
    ``check_every``-th (candidate and node state, bitwise)."""

    def __init__(self, mesh, idle, releasing, task_count, allocatable, pods_limit, node_gate,
                 mins, init_resreq, resreq, static_mask, static_score, *, weights, use_static,
                 enforce_pod_count, has_releasing, batch_runs, score_bound, plain=False,
                 check_every=0, plan: Optional[StepPlan] = None):
        f32 = torch.float32
        self.mesh = mesh
        d = mesh.size
        n, r_dim = allocatable.shape
        n_local = n // d
        self.n, self.r_dim, self.n_local = n, r_dim, n_local
        self.flags = dict(weights=tuple(float(w) for w in weights), use_static=use_static,
                          enforce_pod_count=enforce_pod_count, has_releasing=has_releasing,
                          batch_runs=batch_runs, score_bound=score_bound)
        whole_state = torch.cat([
            torch.as_tensor(idle, dtype=f32).reshape(n, r_dim),
            torch.as_tensor(releasing, dtype=f32).reshape(n, r_dim),
            torch.as_tensor(task_count).to(f32).reshape(n, 1),
        ], dim=1)
        by_dev = {}

        def on(dev, t):
            key = (str(dev), id(t))
            if key not in by_dev:
                by_dev[key] = t.to(dev).contiguous()
            return by_dev[key]

        self.shards = []
        for k, dev in enumerate(mesh.devices):
            lo = k * n_local
            self.shards.append(_Shard(
                k, dev, whole_state[lo:lo + n_local].to(dev).contiguous(),
                allocatable.shards[k], pods_limit.shards[k], node_gate.shards[k],
                on(dev, mins), on(dev, init_resreq), on(dev, resreq),
                static_mask.shards[k] if use_static else static_mask,
                static_score.shards[k] if use_static else static_score, lo))
        self.cuda = mesh.first.type == "cuda"
        self.kernel = self.cuda and not plain
        self.check_every = check_every if self.kernel else 0
        self.checked = 0
        self.xla_ms = 0.0 if self.cuda else None
        self.host_ms = 0.0 if self.cuda else None
        self.steps = 0
        self.push = None  # (shard, local row, task row, m, alloc, pipe)
        self.plan = None
        if self.kernel:
            self.plan = plan or step_plan(n_local)
            self._bind()

    def _bind(self) -> None:
        self._lib = _shard_library()
        f32 = torch.float32
        use_static = self.flags["use_static"]
        for sh in self.shards:
            nl, r_dim = self.n_local, self.r_dim
            t_rows = sh.resreq.shape[0]
            for name, t, dtype, shape in (
                ("allocatable", sh.allocatable, f32, (nl, r_dim)),
                ("pods_limit", sh.pods_limit, torch.int32, (nl,)),
                ("node_gate", sh.node_gate, torch.bool, (nl,)),
                ("mins", sh.mins, f32, (r_dim,)),
                ("init_resreq", sh.init_resreq, f32, (t_rows, r_dim)),
                ("resreq", sh.resreq, f32, (t_rows, r_dim)),
            ):
                if t.device != sh.device or t.dtype != dtype or tuple(t.shape) != shape \
                        or not t.is_contiguous():
                    raise ValueError(f"xla_step shard {sh.k}: {name} must be a contiguous "
                                     f"{dtype} tensor of shape {shape} on {sh.device}")
            if use_static and (sh.static_mask.shape[1] != nl or sh.static_score.shape[1] != nl
                               or not sh.static_mask.is_contiguous()
                               or not sh.static_score.is_contiguous()):
                raise ValueError(f"xla_step shard {sh.k}: static rows must be [S, {nl}] blocks")
            args = XlaShardLoop()
            p = args.q.p
            p.ns, p.alloc, p.plim, p.gate = (sh.node_state.data_ptr(), sh.allocatable.data_ptr(),
                                             sh.pods_limit.data_ptr(), sh.node_gate.data_ptr())
            p.smask, p.sscore = sh.static_mask.data_ptr(), sh.static_score.data_ptr()
            p.initq, p.req, p.mins = (sh.init_resreq.data_ptr(), sh.resreq.data_ptr(),
                                      sh.mins.data_ptr())
            p.n, p.r = nl, r_dim
            p.cpu_idx, p.mem_idx = 0, 1  # api/vocab.py CPU, MEMORY
            for key in ("use_static", "enforce_pod_count", "has_releasing", "batch_runs",
                        "score_bound"):
                setattr(p, key, int(bool(self.flags[key])))
            p.w_lr, p.w_bal, p.w_bp = self.flags["weights"]
            args.q.offset = sh.offset
            args.s_stride = nl
            args.t_rows = t_rows
            args.s_rows = sh.static_mask.shape[0] if use_static else 0
            args.threads = self.plan.threads
            sh.args = args
            sh.addr = ctypes.addressof(args)
            sh.stream = torch.cuda.current_stream(sh.device).cuda_stream
            rc = self._lib.xla_shard_loop_begin(sh.addr)
            if rc != 0:
                self._lib.xla_shard_loop_end(sh.addr)
                sh.addr = None
                self.close()
                raise RuntimeError(f"xla_step shard {sh.k}: plan, mapped result or event "
                                   f"setup failed: CUDA error {rc} ({self.plan})")
            sh.words = np.frombuffer(
                (ctypes.c_int32 * SHARD_CAND.WORDS).from_address(args.out_host), dtype=np.int32)

    def _plain(self, sh, node_state, t_idx, s_idx, hi0, push, scan=True):
        return xla_shard_reference(node_state, sh.allocatable, sh.pods_limit, sh.node_gate,
                                   sh.mins, sh.init_resreq, sh.resreq, sh.static_mask,
                                   sh.static_score, t_idx, s_idx, hi0, offset=sh.offset,
                                   push=push, scan=scan, consts=sh.consts, **self.flags)

    def _push_for(self, sh):
        if self.push is None or self.push[0] != sh.k:
            return None
        return self.push[1:]

    def _launch(self, sh, t_idx, s_idx, hi0, push, scan) -> None:
        global shard_launches
        row, pt, pm, pa, pp = push if push is not None else (-1, 0, 0, 0, 0)
        rc = self._lib.xla_shard_loop_launch(
            sh.addr, t_idx, s_idx if self.flags["use_static"] else 0, hi0, row, pt, pm,
            int(pa), int(pp), int(scan), sh.stream)
        if rc != 0:
            raise RuntimeError(f"xla_step shard {sh.k} launch failed: CUDA error {rc} "
                               f"({self.plan})")
        shard_launches += 1

    def step(self, t_idx: int, s_idx: int, hi0: int):
        self.steps += 1
        t0 = time.perf_counter()
        if not self.kernel:
            cands = [self._plain(sh, sh.node_state, t_idx, s_idx, hi0, self._push_for(sh))
                     for sh in self.shards]
        else:
            check = self.check_every and (self.steps - 1) % self.check_every == 0
            twins = wants = None
            if check:
                twins = [sh.node_state.clone() for sh in self.shards]
                wants = [self._plain(sh, tw, t_idx, s_idx, hi0, self._push_for(sh))
                         for sh, tw in zip(self.shards, twins)]
            for sh in self.shards:
                self._launch(sh, t_idx, s_idx, hi0, self._push_for(sh), True)
            cands = []
            for sh in self.shards:
                rc = self._lib.xla_shard_loop_wait(sh.addr, sh.stream)
                if rc != 0:
                    raise RuntimeError(f"xla_step shard {sh.k}: CUDA error {rc}")
                cands.append(_decode(sh.words.copy()))
            if check:
                self.checked += 1
                for sh, tw, want, got in zip(self.shards, twins, wants, cands):
                    same = torch.equal(sh.node_state.view(torch.int32), tw.view(torch.int32))
                    if not same_candidate(got, want) or not same:
                        raise RuntimeError(
                            f"xla_step shard {sh.k}: kernel {got[:8]} != plain {want[:8]} "
                            f"(node state equal: {same}) at loop step {self.steps}, task row "
                            f"{t_idx}")
        best, feasible, alloc_here, pipe_here, m = merge_shard_candidates(
            cands, hi0, has_releasing=self.flags["has_releasing"],
            batch_runs=self.flags["batch_runs"], score_bound=self.flags["score_bound"],
            enforce_pod_count=self.flags["enforce_pod_count"])
        if alloc_here or pipe_here:
            k, row = divmod(best, self.n_local)
            self.push = (k, row, t_idx, m, alloc_here, pipe_here)
        else:
            self.push = None
        if self.cuda:
            self.host_ms += 1e3 * (time.perf_counter() - t0)
        return best, feasible, alloc_here, pipe_here, m

    def flush(self) -> None:
        """Apply a pending row add (the last step's winner) to its shard."""
        if self.push is None:
            return
        sh = self.shards[self.push[0]]
        if self.kernel:
            self._launch(sh, 0, 0, 1, self.push[1:], False)
            rc = self._lib.xla_shard_loop_wait(sh.addr, sh.stream)
            if rc != 0:
                raise RuntimeError(f"xla_step shard {sh.k}: CUDA error {rc}")
        else:
            self._plain(sh, sh.node_state, 0, 0, 1, self.push[1:], scan=False)
        self.push = None

    def node_state(self) -> torch.Tensor:
        """The whole node state, gathered on the first device (after
        ``flush``)."""
        return torch.cat([sh.node_state.to(self.mesh.first) for sh in self.shards])

    def close(self) -> None:
        """Release each shard's events and mapped candidate; sum the kernel's
        time over the shards."""
        err = 0
        total = 0.0
        for sh in self.shards:
            if sh.addr is not None:
                sh.words = None
                rc = self._lib.xla_shard_loop_end(sh.addr)
                total += float(sh.args.xla_ms)
                sh.addr = None
                err = err or rc
        if self.kernel:
            self.xla_ms = total
        if err:
            raise RuntimeError(f"xla_step shard: CUDA error {err}")
