"""The whole greedy allocate action as ONE CUDA kernel launch.

This replaces ``scheduler_tpu/ops/megakernel.py::mega_allocate`` (a Pallas
TPU kernel) in CURSOR MODE: one queue, jobs laid out in init-key order, no
releasing capacity, no static [T, N] rows.  The kernel source is
``csrc/mega_allocate.cu``; it is built with ``nvcc`` at first use into
``build/scheduler_tpu_torch/`` (keyed on a hash of the source) and bound
through a plain C entry point with ``ctypes``.

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
the unused multi-queue / static / releasing ones as dummies): codes are
>= 0 node, -1 unplaced, -2 failed (first infeasible task of its pop); the
second output holds the 8 ``STATS`` counters.

Where the kernel's time goes on the card: the loop is a dependent chain of
about ``STATS.STEPS`` steps, each needing block-wide reductions over the
node axis (fit, score, argmax) — per-step latency bounds it, not bytes or
FLOPs.  The design is one persistent 1024-thread block; the later redesigns
are a thread-block cluster with the node ledger in distributed shared
memory, or a cooperative grid.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops.layout import (
    JOB_SCRATCH as JROW,
    NODE_SCRATCH as NROW,
    SIG_REQ,
    STATS,
    STATS_WIDTH,
    node_scratch_rows,
)

# Result encoding — MUST match ops/fused.py.
UNPLACED = -1
FAILED = -2
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


def _check_mode(has_releasing, use_static, multi_queue, qfair_ladder, mesh) -> None:
    """Only cursor mode is ported; every other kernel mode raises."""
    for flag, name in (
        (has_releasing, "releasing capacity"),
        (use_static, "static [T,N] rows"),
        (multi_queue, "multi-queue proportion"),
        (qfair_ladder, "qfair ladder"),
        (mesh is not None, "mesh"),
    ):
        if flag:
            raise NotImplementedError(f"mega_allocate mode not ported: {name}")


# -- build + bind -------------------------------------------------------------

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "mega_allocate.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
_lib = None
build_info: dict = {}


def _build_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "build", "scheduler_tpu_torch")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class _MegaArgs(ctypes.Structure):
    """Mirror of ``struct MegaArgs`` in ``csrc/mega_allocate.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "ns0", "alloc_t", "gate", "plim", "sig_req", "task_sig", "run_len",
            "job_off", "job_num", "job_def", "job_gang", "job_prio", "job_tb",
            "js_drf0", "drf_safe", "drf_mask", "misc",
            "out", "stats", "ns", "msk", "js_global",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "nb", "s_pad", "t_rows", "t_cap", "j_pad", "js_rows", "r_dim",
            "cpu_idx", "mem_idx", "enforce_pod_count", "cross_batch",
            "batch_runs", "score_bound", "cohort", "n_comp", "smem_bytes",
        )
    ] + [
        ("comp", ctypes.c_int * 4),
        ("w_lr", ctypes.c_float),
        ("w_bal", ctypes.c_float),
        ("w_bp", ctypes.c_float),
        ("mins", ctypes.c_float * 8),
    ]


def build(verbose: bool = False) -> dict:
    """Compile ``csrc/mega_allocate.cu`` (once per source hash) and load it.
    Returns the build record: library path, seconds spent compiling (0 when
    the library was already built) and the compiler's output."""
    global _lib, build_info
    if _lib is not None:
        return build_info
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"mega_allocate-{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, _SRC]
        start = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = (res.stdout + res.stderr).strip()
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {_SRC}:\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.mega_allocate_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mega_allocate_launch.restype = ctypes.c_int
    _lib = lib
    build_info = {"path": path, "seconds": seconds, "log": log}
    return build_info


# -- the wrapper ----------------------------------------------------------------

# Job scratch beyond this many bytes lives in device memory instead of
# shared memory (an SM offers 227 KB to one block).
_SMEM_JOB_LIMIT = 200 * 1024


def job_ledger_bytes(j_pad: int, r_dim: int) -> int:
    """Bytes of the kernel's job ledger: it sits in shared memory up to
    ``_SMEM_JOB_LIMIT`` and in global scratch past it."""
    return (JROW.DRF + r_dim) * j_pad * 4


def job_ledger_in_global(j_pad: int, r_dim: int) -> bool:
    return job_ledger_bytes(j_pad, r_dim) > _SMEM_JOB_LIMIT


def _expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def mega_allocate(*operands: torch.Tensor, **kw):
    """Run the whole allocate loop: ``(codes i32 [t_cap], stats i32 [8])``.

    Takes the JAX kernel's 26 operands (``OPERAND_NAMES``) and static
    arguments.  CPU operands run ``mega_allocate_reference``; CUDA operands
    launch the kernel, which raises if the launch is refused."""
    if len(operands) != len(OPERAND_NAMES):
        raise TypeError(f"mega_allocate takes {len(OPERAND_NAMES)} operands")
    kw.pop("interpret", None)
    _check_mode(kw.get("has_releasing"), kw.get("use_static"),
                kw.get("multi_queue"), kw.get("qfair_ladder", False),
                kw.get("mesh"))
    if operands[0].device.type == "cpu":
        return mega_allocate_reference(*operands, **kw)
    return _launch(*operands, **kw)


def _launch(ns0, alloc_t, rel0, gate, plim, sig_req, task_sig, run_len,
            job_off, job_num, job_deficit, job_gang, job_prio, job_tb,
            js_drf0, drf_safe, drf_mask, msig, smask, sscore, jqueue, jq_des,
            jq_alloc0, qf_share, qf_over, misc, *, r_dim, weights,
            enforce_pod_count, comparators, cross_batch, batch_runs,
            has_releasing, use_static, score_bound, mins, cpu_idx, mem_idx,
            multi_queue, queue_proportion=False, overused_gate=False,
            queue_delta=True, qfair_ladder=False, cohort=1, t_cap=0,
            mesh=None):
    global launches
    del rel0, msig, smask, sscore, jqueue, jq_des, jq_alloc0, qf_share, qf_over
    del has_releasing, use_static, multi_queue, queue_proportion
    del overused_gate, queue_delta, qfair_ladder, mesh
    nb = ns0.shape[1]
    s_pad = sig_req.shape[1]
    t_rows = task_sig.shape[0]
    j_pad = job_off.shape[1]
    if not 0 < r_dim <= 8 or len(comparators) > 3 or nb <= 0:
        raise ValueError("mega_allocate: unsupported r_dim, comparators or node count")
    f32, i32 = torch.float32, torch.int32
    _expect(ns0, "ns0", f32, (node_scratch_rows(False), nb))
    _expect(alloc_t, "alloc_t", f32, (8, nb))
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
    t_pad = t_rows * 128
    if t_cap <= 0:
        t_cap = t_pad
    if not batch_runs:
        cohort = 1
    cohort = max(1, int(cohort))

    if _lib is None:
        build()
    dev = ns0.device
    out = torch.empty((t_rows + 1) * 128, dtype=i32, device=dev)
    stats = torch.empty(STATS_WIDTH, dtype=i32, device=dev)
    ns = torch.empty((node_scratch_rows(False), nb), dtype=f32, device=dev)
    msk = torch.empty(nb, dtype=f32, device=dev)
    js_rows = JROW.DRF + r_dim
    js_bytes = job_ledger_bytes(j_pad, r_dim)
    js_global = None
    if job_ledger_in_global(j_pad, r_dim):
        js_global = torch.empty((js_rows, j_pad), dtype=f32, device=dev)

    args = _MegaArgs()
    for field, t in (
        ("ns0", ns0), ("alloc_t", alloc_t), ("gate", gate), ("plim", plim),
        ("sig_req", sig_req), ("task_sig", task_sig), ("run_len", run_len),
        ("job_off", job_off), ("job_num", job_num), ("job_def", job_deficit),
        ("job_gang", job_gang), ("job_prio", job_prio), ("job_tb", job_tb),
        ("js_drf0", js_drf0), ("drf_safe", drf_safe), ("drf_mask", drf_mask),
        ("misc", misc), ("out", out), ("stats", stats), ("ns", ns),
        ("msk", msk),
    ):
        setattr(args, field, t.data_ptr())
    args.js_global = js_global.data_ptr() if js_global is not None else None
    args.nb, args.s_pad, args.t_rows, args.t_cap = nb, s_pad, t_rows, t_cap
    args.j_pad, args.js_rows, args.r_dim = j_pad, js_rows, r_dim
    args.cpu_idx, args.mem_idx = cpu_idx, mem_idx
    args.enforce_pod_count = int(bool(enforce_pod_count))
    args.cross_batch = int(bool(cross_batch))
    args.batch_runs = int(bool(batch_runs))
    args.score_bound = int(bool(score_bound))
    args.cohort = cohort
    args.n_comp = len(comparators)
    for i, name in enumerate(comparators):
        args.comp[i] = _COMPARATOR_CODES[name]
    args.smem_bytes = 0 if js_global is not None else js_bytes
    args.w_lr, args.w_bal, args.w_bp = (float(w) for w in weights)
    for i in range(8):
        args.mins[i] = float(mins[i]) if i < len(mins) else 0.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib.mega_allocate_launch(ctypes.addressof(args), stream)
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
    del rel0, msig, smask, sscore, jqueue, jq_des, jq_alloc0, qf_share, qf_over
    del queue_proportion, overused_gate, queue_delta, interpret
    _check_mode(has_releasing, use_static, multi_queue, qfair_ladder, mesh)
    dev = ns0.device
    f32, i32 = torch.float32, torch.int32
    n = ns0.shape[1]
    t_rows = task_sig.shape[0]
    t_pad = t_rows * 128
    if t_cap <= 0:
        t_cap = t_pad
    j_pad = job_off.shape[1]
    if not batch_runs:
        cohort = 1
    cohort = max(1, int(cohort))
    lr_w, bal_w, bp_w = (float(w) for w in weights)
    max_steps = t_cap + 8
    neg_inf, pos_inf = float("-inf"), float("inf")

    # Live state: node ledger (idle rows + task count), job ledger, result.
    ns = ns0.clone()
    js = torch.zeros((JROW.QUEUE_ALLOC, j_pad), dtype=f32, device=dev)
    js[JROW.DRF : JROW.QUEUE_ALLOC] = js_drf0
    out = torch.full(((t_rows + 1) * 128,), UNPLACED, dtype=i32, device=dev)

    # Read-only tables the scalar control flow indexes.
    tsig = task_sig.reshape(-1).tolist()
    rlen = run_len.reshape(-1).tolist()
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
        """Comparator chain over the job lanes: priority -> gang -> drf, then
        the creation/uid rank, lowest lane on ties; HALT when none is left."""
        cand = (
            (js[JROW.LEFT] == 0.0)
            & (js[JROW.CONSUMED] < jnum_f)
            & (jnum > 0)
            & (lane_j <= cursor)
        )
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

    cur, cursor, n_dirty = -1, 0, 0
    steps = coh_steps = chunk_pl = 0
    while steps < max_steps and (
        cur >= 0 or (cur != HALT and (cursor < n_real or n_dirty > 0))
    ):
        # ---- selection (cursor mode) ----
        if cur == -1:
            if n_dirty > 0:
                sel = chain_select(cursor)
            else:
                sel = cursor if cursor < n_real else HALT
        else:
            sel = cur
        newly = cur == -1 and sel >= 0
        cursor_r = cursor + int(newly and sel == cursor)
        dirty_r = n_dirty - int(newly and sel != cursor)
        cur_r = sel

        jb = min(max(sel, 0), j_pad - 1)
        cons_c, nalloc_c = js[[JROW.CONSUMED, JROW.ALLOCATED], jb].tolist()
        num_v, deficit_v = jnum_l[jb], jdef[jb]
        t_c = min(max(joff[jb] + int(cons_c), 0), t_pad - 1)
        sig = tsig[t_c]
        rl_c = rlen[t_c]
        reqs = sig_req[SIG_REQ.REQ : SIG_REQ.REQ + r_dim, sig]
        initqs = sig_req[SIG_REQ.INIT : SIG_REQ.INIT + r_dim, sig]
        single0 = num_v == 1
        act = sel >= 0

        # ---- cohort chunks: chunk 0 is the step's placement; chunks 1.. place
        # the next segment of the same cohort on the live ledgers ----
        for c in range(cohort):
            if not act:
                break
            # fit + score + masked argmax over every node
            feas = gate_v
            for r in range(r_dim):
                feas = feas & (
                    (initqs[r] < idle[r]) | (torch.abs(idle[r] - initqs[r]) < mins[r])
                )
            if enforce_pod_count:
                feas = feas & (tcount < plim_v)
            score = torch.zeros(n, dtype=f32, device=dev)
            if lr_w or bal_w or bp_w:
                req_c = a_c - idle[cpu_idx] + reqs[cpu_idx]
                req_m = a_m - idle[mem_idx] + reqs[mem_idx]
                score = scores(a_c, a_m, safe_c, safe_m, req_c, req_m, score)
            masked = torch.where(feas, score, neg_inf)
            maxv = masked.max()
            best_t = torch.where(masked == maxv, lane_n, n).min().clamp(max=n - 1)
            feasible, best = torch.stack([(maxv > neg_inf).to(best_t.dtype), best_t]).tolist()
            alloc_here = bool(feasible)
            failed = not alloc_here

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
                    ok_s = (s_js > second) | ((s_js == second) & (best < second_idx))
                    first_false = torch.where(~ok_s, js_vec, MAX_BATCH + 1).min()
                    ok = ok & (js_vec < first_false)
                m = int(torch.where(ok & (js_vec <= hi0), js_vec, 1).max())
            cross_active = cross_batch and single0 and alloc_here
            consumed = m if alloc_here else int(failed)
            m_alloc = float(m) if alloc_here else 0.0

            # node ledger: the winner's column
            if alloc_here:
                idle[:, best] -= reqs * m_alloc
                tcount[best] += m_alloc

            # job ledger: one lane, or the window of a cross-job batch
            k = m if cross_active else 1
            win = slice(jb, min(jb + k, j_pad))
            js[JROW.CONSUMED, win] += 1.0 if cross_active else float(consumed)
            js[JROW.ALLOCATED, win] += 1.0 if cross_active else m_alloc
            js[JROW.LEFT, win] += 0.0 if cross_active else float(failed)
            drf_scale = 1.0 if cross_active else m_alloc
            js[JROW.DRF : JROW.DRF + r_dim, win] += (reqs * drf_scale)[:, None]

            # result codes of the consumed tasks
            code = best if alloc_here else FAILED
            out[t_c : t_c + consumed] = code

            # pop end / running scalars
            row_after_alloc = nalloc_c + (1.0 if cross_active else m_alloc)
            became_ready = alloc_here and row_after_alloc >= deficit_v
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


def build_node_ledgers(idle: torch.Tensor, task_count: torch.Tensor, nb: int, r: int):
    """Kernel-layout node ledger from [N, R] node state: the packed [16, N]
    idle + task-count block (rows 0..r-1 idle, row 8 task count)."""
    ns0 = torch.zeros((NROW.RELEASING, nb), dtype=torch.float32, device=idle.device)
    ns0[NROW.IDLE : NROW.IDLE + r] = idle.T
    ns0[NROW.TASK_COUNT] = task_count.to(torch.float32)
    return ns0
