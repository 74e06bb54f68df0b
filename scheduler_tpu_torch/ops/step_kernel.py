"""The placement step (K1) of the ``fused_allocate`` loop as ONE CUDA launch.

This replaces ``scheduler_tpu/ops/pallas_kernels.py:117``
``make_placement_step`` (a Pallas TPU kernel): one micro-step's selection —
epsilon fit, gates, static mask, dynamic + static score, masked
lowest-index argmax and, with ``with_capacity``, the winner's capacity and
pod room — over transposed node ledgers (nodes on the minor axis).  The
kernel source is ``csrc/placement_step.cu``; it is built with the port's
other kernels at first use (``ops/cuda_build.py``) and bound through plain C
entry points with ``ctypes``.

* ``StepLoop`` — the kernel bound once for a whole loop: operands staged,
  one C call a step that launches the kernel (the task's rows and the node
  column the host changed ride in the launch parameters) and waits; the
  kernel writes its four results to mapped pinned host memory.  Each launch
  adds one to ``launches``.
* ``placement_step`` — the one-step wrapper.  CUDA tensors run one step of
  a ``StepLoop`` bound to them (or raise); CPU tensors run
  ``placement_step_reference``.
* ``placement_step_reference`` — the plain PyTorch version, line for line
  the JAX kernel body (``pallas_kernels.py:157-227``).

Shapes and dtypes (the JAX docstring, ``pallas_kernels.py:131-141``):
``ns`` f32 [r8 + 8, n] (idle rows 0..r8-1, task count row r8), ``alloc`` f32
[r8, n], ``smask`` bool [1, n], ``sscore`` f32 [1, n], ``gate`` bool [1, n],
``plim`` f32 [1, n], ``initq`` / ``req`` / ``mins`` f32 [r8, 1] (initq pad
rows -1, req pad rows 0).  Outputs ``(best i32, score f32, cap i32, pods
i32)``: lowest-index argmax of the masked score and its value (-inf:
nothing feasible, then best is 0), and under ``with_capacity`` the largest
j <= ``CAP_GRID`` whose j-th sequential placement still fits the winner
plus its pod room (zeros without it).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.layout import STEP_NODE

# Candidate grid of the capacity count — equals ``ops/fused.py`` MAX_BATCH.
CAP_GRID = 128

# Launches of the CUDA kernel (the CPU path and the plain version never count).
launches = 0


# -- the plain PyTorch version ---------------------------------------------------

def placement_step_reference(ns, alloc, smask, sscore, gate, plim, initq, req, mins, *,
                             r_dim, r8, weights, use_static, enforce_pod_count,
                             cpu_idx, mem_idx, with_capacity
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on the inputs' device: the
    JAX kernel body's operations in its order (0-d result tensors)."""
    del r_dim
    n = ns.shape[1]
    dev = ns.device
    lr_w, bal_w, bp_w = (float(w) for w in weights)
    idle = ns[STEP_NODE.IDLE:r8, :]
    fit = (initq < idle) | ((idle - initq).abs() < mins)
    feasible = fit.all(dim=0, keepdim=True)
    feasible = feasible & gate
    if use_static:
        feasible = feasible & smask
    if enforce_pod_count:
        feasible = feasible & (ns[r8:r8 + 1, :] < plim)

    score = torch.zeros((1, n), dtype=torch.float32, device=dev)
    if lr_w or bal_w or bp_w:
        requested = alloc - idle + req
        safe = torch.where(alloc > 0, alloc, 1.0)
        if bp_w:
            frac = torch.clamp(requested / safe, 0.0, 1.0)
            fc = frac[cpu_idx:cpu_idx + 1, :]
            fm = frac[mem_idx:mem_idx + 1, :]
            score = score + bp_w * (((fc + fm) / 2.0) * 10.0)
        if lr_w:
            lfrac = torch.clamp((alloc - requested) / safe, 0.0, 1.0)
            lc = lfrac[cpu_idx:cpu_idx + 1, :]
            lm = lfrac[mem_idx:mem_idx + 1, :]
            score = score + lr_w * (((lc + lm) / 2.0) * 10.0)
        if bal_w:
            bfrac = torch.clamp(requested / safe, 0.0, 1.0)
            diff = (bfrac[cpu_idx:cpu_idx + 1, :] - bfrac[mem_idx:mem_idx + 1, :]).abs()
            score = score + bal_w * ((1.0 - diff) * 10.0)
    if use_static:
        score = score + sscore

    masked = torch.where(feasible, score, float("-inf"))
    maxv = masked.max()
    lanes = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    best = torch.where(masked == maxv, lanes, n).min().to(torch.int32)
    i32 = torch.int32
    if not with_capacity:
        zero = torch.zeros((), dtype=i32, device=dev)
        return best, maxv, zero, zero.clone()
    onehot = lanes == best
    idle_b = torch.where(onehot, idle, 0.0).sum(dim=1, keepdim=True)
    jsv = torch.arange(1, CAP_GRID + 1, dtype=i32, device=dev)[None, :]
    avail = idle_b - (jsv - 1).to(torch.float32) * req
    okb = (initq < avail) | ((avail - initq).abs() < mins)
    ok_all = okb.all(dim=0, keepdim=True)
    cap = torch.where(ok_all, jsv, 0).max().to(i32)
    if enforce_pod_count:
        tc_b = torch.where(onehot, ns[r8:r8 + 1, :], 0.0).sum()
        pl_b = torch.where(onehot, plim, 0.0).sum()
        pods = (pl_b - tc_b).to(i32)
    else:
        pods = torch.full((), CAP_GRID, dtype=i32, device=dev)
    return best, maxv, cap, pods


def same_result(a, b) -> bool:
    """Two ``(best, score, cap, pods)`` results are equal bit for bit."""
    return (a[0], a[2], a[3]) == (b[0], b[2], b[3]) and (
        np.float32(a[1]).tobytes() == np.float32(b[1]).tobytes())


def max_abs_err(a, b) -> float:
    """Largest absolute difference between two ``(best, score, cap, pods)``
    results; equal infinite scores count 0."""
    errs = [abs(float(x) - float(y)) for i, (x, y) in enumerate(zip(a, b))
            if not (i == 1 and float(x) == float(y))]
    return max(errs, default=0.0)


# -- bind ------------------------------------------------------------------------

# Task rows and pushed values travel in the launch parameters, so r8 is capped
# (the kernel reads the idle rows eight at a time: r8 is 8 or 16).
MAX_R8 = 16


class StepParams(ctypes.Structure):
    """Mirror of ``struct StepParams`` in ``csrc/placement_step.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("ns", "alloc", "smask", "sscore", "gate", "plim", "out")
    ] + [
        (name, ctypes.c_int)
        for name in ("n", "r8", "cpu_idx", "mem_idx", "use_static", "enforce_pod_count",
                     "with_capacity", "push_col", "vec")
    ] + [(name, ctypes.c_float) for name in ("w_lr", "w_bal", "w_bp")] + [
        (name, ctypes.c_float * MAX_R8) for name in ("initq", "req", "mins")
    ] + [("push", ctypes.c_float * (MAX_R8 + 1))]


class _StepLoopArgs(ctypes.Structure):
    """Mirror of ``struct StepLoop`` in ``csrc/placement_step.cu``."""

    _fields_ = [
        ("p", StepParams),
        ("ns_host", ctypes.c_void_p),
        ("initq", ctypes.c_void_p),
        ("req", ctypes.c_void_p),
        ("out_host", ctypes.c_void_p),
        ("ev0", ctypes.c_void_p),
        ("ev1", ctypes.c_void_p),
        ("k1_ms", ctypes.c_double),
        ("steps", ctypes.c_longlong),
        ("task_stride", ctypes.c_int),
    ]


_lib = None


def _library():
    """The port's CUDA library, with the argument types of this kernel's
    entry points set once."""
    global _lib
    if _lib is None:
        lib = cuda_build.load()
        for name in ("placement_step_loop_begin", "placement_step_loop_end",
                     "placement_step_loop_step", "placement_step_loop_queue",
                     "placement_step_loop_launch", "placement_step_loop_wait",
                     "placement_step_max_r8"):
            getattr(lib, name).restype = ctypes.c_int
        lib.placement_step_loop_begin.argtypes = [ctypes.c_void_p]
        lib.placement_step_loop_end.argtypes = [ctypes.c_void_p]
        lib.placement_step_loop_step.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p]
        lib.placement_step_loop_queue.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_void_p]
        lib.placement_step_loop_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
        lib.placement_step_loop_wait.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.placement_step_max_r8.argtypes = []
        if lib.placement_step_max_r8() != MAX_R8:
            raise RuntimeError("placement_step: the library's MAX_R8 differs from the wrapper's")
        _lib = lib
    return _lib


def _expect(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


# -- the wrapper -----------------------------------------------------------------

def placement_step(ns, alloc, smask, sscore, gate, plim, initq, req, mins, *,
                   r_dim, r8, weights, use_static, enforce_pod_count, cpu_idx,
                   mem_idx, with_capacity):
    """One selection step -> ``(best i32, score f32, cap i32, pods i32)``, 0-d
    tensors on the inputs' device.  CPU tensors run
    ``placement_step_reference``; CUDA tensors run one step of a
    ``StepLoop`` bound to these operands (one launch), which raises if the
    launch is refused."""
    n = ns.shape[1]
    dev = ns.device
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("ns", ns, f32, (r8 + 8, n)), ("alloc", alloc, f32, (r8, n)),
        ("smask", smask, torch.bool, (1, n)), ("sscore", sscore, f32, (1, n)),
        ("gate", gate, torch.bool, (1, n)), ("plim", plim, f32, (1, n)),
        ("initq", initq, f32, (r8, 1)), ("req", req, f32, (r8, 1)), ("mins", mins, f32, (r8, 1)),
    ):
        _expect(name, t, dev, dtype, shape)
    kw = dict(r_dim=r_dim, r8=r8, weights=weights, use_static=use_static,
              enforce_pod_count=enforce_pod_count, cpu_idx=cpu_idx, mem_idx=mem_idx,
              with_capacity=with_capacity)
    if dev.type == "cpu":
        return placement_step_reference(ns, alloc, smask, sscore, gate, plim, initq, req,
                                        mins, **kw)
    if dev.type != "cuda":
        raise ValueError(f"placement_step: no kernel for device {dev}")
    loop = StepLoop.for_one_task(ns, alloc, smask, sscore, gate, plim, initq, req, mins, **kw)
    try:
        best, score, cap, pods = loop.step(0, -1)
    finally:
        loop.close()
    i32 = torch.int32
    out = torch.tensor([best, cap, pods], dtype=i32).to(dev)
    return out[0], torch.tensor(score, dtype=f32).to(dev), out[1], out[2]


# -- the kernel bound for a loop --------------------------------------------------

class StepLoop:
    """K1 bound once for a ``fused_allocate`` loop.

    ``ns_host`` is the host's float32 [r8 + 8, n] node state, which the loop
    updates itself; ``task_initq`` / ``task_req`` hold every task's request
    rows ([T, r8], pad rows -1 / 0), ``smask`` / ``sscore`` every task's
    static rows ([T, n], or [1, n] dummies without ``use_static``), and the
    node operands are those of ``placement_step``.  ``step(t_idx,
    push_col)`` selects for task row ``t_idx`` after the host changed node
    column ``push_col`` (-1: none) of ``ns_host``, and returns ``(best,
    score, cap, pods)`` as Python numbers.

    On the CPU (or with ``plain``) each step is ``placement_step_reference``;
    on CUDA it is one C call: one launch, whose parameters carry the task's
    rows and the changed column (the kernel writes that column into the
    card's copy of the node state), and a wait; the kernel writes its four
    results to mapped pinned host memory.  CUDA events around each launch
    are summed into ``k1_ms``.  With ``check_every`` > 0 the kernel's four
    outputs are held to the plain version on the same device operands at
    the first step and every ``check_every``-th one (``checked`` counts
    them); a disagreement raises."""

    def __init__(self, ns_host: np.ndarray, alloc, smask, sscore, gate, plim,
                 task_initq, task_req, mins, *, device, plain=False, check_every=0, **kw):
        self.kw = kw
        self.r8 = kw["r8"]
        self.use_static = kw["use_static"]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda" and not plain
        self.check_every = check_every if self.cuda else 0
        self.checked = 0
        self.k1_ms = None
        self.steps = 0
        self._addr = None
        if self.cuda and (self.r8 % 8 or self.r8 > MAX_R8):
            raise ValueError(f"placement_step: r8 {self.r8} is not 8 or 16, as the kernel needs")
        if ns_host.dtype != np.float32 or not ns_host.flags.c_contiguous:
            raise ValueError("placement_step: ns_host must be a C-contiguous float32 array")
        # The loop updates ns_host in place; the kernel reads the changed
        # column from it through each launch's parameters.
        self.ns_host = ns_host
        if self.device.type == "cpu":
            self.ns = torch.from_numpy(ns_host)  # the plain version reads the host's array
        else:
            self.ns = torch.from_numpy(ns_host).to(self.device)
        self.alloc, self.gate, self.plim, self.mins = alloc, gate, plim, mins
        self.smask, self.sscore = smask, sscore
        self.task_initq, self.task_req = task_initq, task_req
        if self.cuda:
            self._bind()

    @classmethod
    def for_one_task(cls, ns, alloc, smask, sscore, gate, plim, initq, req, mins, **kw):
        """A loop over the one task of ``placement_step``'s operands (task
        row 0), on their device."""
        return cls(ns.detach().cpu().numpy().copy(), alloc.contiguous(), smask.contiguous(),
                   sscore.contiguous(), gate.contiguous(), plim.contiguous(),
                   initq.reshape(1, -1).contiguous(), req.reshape(1, -1).contiguous(),
                   mins.contiguous(), device=ns.device, **kw)

    def _bind(self) -> None:
        kw = self.kw
        self._lib = _library()
        # Host copies of the task rows: each launch's parameters carry one.
        self.initq_host = np.ascontiguousarray(self.task_initq.detach().cpu().numpy(), np.float32)
        self.req_host = np.ascontiguousarray(self.task_req.detach().cpu().numpy(), np.float32)
        args = _StepLoopArgs()
        p = args.p
        p.ns, p.alloc, p.gate, p.plim = (self.ns.data_ptr(), self.alloc.data_ptr(),
                                         self.gate.data_ptr(), self.plim.data_ptr())
        p.smask, p.sscore = self.smask.data_ptr(), self.sscore.data_ptr()
        p.n, p.r8, p.cpu_idx, p.mem_idx = (self.ns.shape[1], self.r8, kw["cpu_idx"],
                                           kw["mem_idx"])
        p.use_static = int(bool(self.use_static))
        p.enforce_pod_count = int(bool(kw["enforce_pod_count"]))
        p.with_capacity = int(bool(kw["with_capacity"]))
        p.push_col = -1
        p.w_lr, p.w_bal, p.w_bp = (float(w) for w in kw["weights"])
        for r, m in enumerate(self.mins.reshape(-1).detach().cpu().numpy()):
            p.mins[r] = float(m)
        args.ns_host = self.ns_host.ctypes.data
        args.initq = self.initq_host.ctypes.data
        args.req = self.req_host.ctypes.data
        args.task_stride = self.r8
        self._args = args
        self._addr = ctypes.addressof(args)
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.placement_step_loop_begin(self._addr)
        if rc != 0:
            self._lib.placement_step_loop_end(self._addr)
            self._addr = None
            raise RuntimeError("placement_step: mapped result or event setup failed: "
                               f"CUDA error {rc}")
        # The kernel's four results, in mapped pinned host memory.
        self.res_i = (ctypes.c_int32 * 4).from_address(args.out_host)
        self.res_f = (ctypes.c_float * 4).from_address(args.out_host)

    def step(self, t_idx: int, push_col: int):
        global launches
        self.steps += 1
        if self.cuda:
            rc = self._lib.placement_step_loop_step(self._addr, t_idx, push_col, self._stream)
            if rc != 0:
                raise RuntimeError(f"placement_step launch failed: CUDA error {rc}")
            launches += 1
            res_i = self.res_i
            result = res_i[0], self.res_f[1], res_i[2], res_i[3]
            if self.check_every and (self.steps - 1) % self.check_every == 0:
                self._check(t_idx, result)
            return result
        if push_col >= 0 and self.device.type != "cpu":
            col = torch.from_numpy(np.ascontiguousarray(self.ns_host[: self.r8 + 1, push_col]))
            self.ns[: self.r8 + 1, push_col] = col.to(self.device)
        return self._plain(t_idx)

    def launch(self, t_idx: int, push_col: int) -> None:
        """``step``'s launch without its wait (CUDA only): one launch queued
        on the stream; ``finish`` waits for it and returns its result.  A
        step over a node mesh launches every shard's loop before it waits
        on any."""
        global launches
        self.steps += 1
        rc = self._lib.placement_step_loop_launch(self._addr, t_idx, push_col, self._stream)
        if rc != 0:
            raise RuntimeError(f"placement_step launch failed: CUDA error {rc}")
        launches += 1
        self._pending = t_idx

    def finish(self):
        """Wait for the launch ``launch`` queued and return its four results
        (held to the plain version as ``step`` holds them)."""
        rc = self._lib.placement_step_loop_wait(self._addr, self._stream)
        if rc != 0:
            raise RuntimeError(f"placement_step: CUDA error {rc}")
        res_i = self.res_i
        result = res_i[0], self.res_f[1], res_i[2], res_i[3]
        if self.check_every and (self.steps - 1) % self.check_every == 0:
            self._check(self._pending, result)
        return result

    def queue(self, t_idx: int, count: int) -> None:
        """``count`` launches for task row ``t_idx`` queued back to back on
        the stream, no push and no wait (timing the kernel apart from the
        round trip; CUDA only)."""
        global launches
        rc = self._lib.placement_step_loop_queue(self._addr, t_idx, count, self._stream)
        if rc != 0:
            raise RuntimeError(f"placement_step launch failed: CUDA error {rc}")
        launches += count

    def _plain(self, t_idx: int):
        """The plain version on the loop's device operands for task row t_idx."""
        srow = t_idx if self.use_static else 0
        best, score, cap, pods = placement_step_reference(
            self.ns, self.alloc, self.smask[srow:srow + 1], self.sscore[srow:srow + 1],
            self.gate, self.plim, self.task_initq[t_idx][:, None], self.task_req[t_idx][:, None],
            self.mins, **self.kw)
        if self.device.type == "cpu":
            return int(best), float(score), int(cap), int(pods)
        packed = torch.stack([best, score.view(torch.int32), cap, pods]).cpu().numpy()
        return int(packed[0]), float(packed[1:2].view(np.float32)[0]), int(packed[2]), int(packed[3])

    def _check(self, t_idx: int, result) -> None:
        """Hold the kernel's result to the plain version on the same device
        state (the kernel wrote the pushed column before it returned)."""
        plain = self._plain(t_idx)
        self.checked += 1
        if not same_result(result, plain):
            raise RuntimeError(f"placement_step: kernel {result} != plain {plain} "
                               f"at loop step {self.steps}, task row {t_idx}")

    def close(self) -> None:
        """Release the events and the mapped result; keep the kernel's
        summed time."""
        if self.cuda and self._addr is not None:
            self.res_i = self.res_f = None
            rc = self._lib.placement_step_loop_end(self._addr)
            self.k1_ms = float(self._args.k1_ms)
            self._addr = None
            if rc != 0:
                raise RuntimeError(f"placement_step: CUDA error {rc}")
