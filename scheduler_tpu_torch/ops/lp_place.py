"""LP-relaxed batch placement on one device (``scheduler_tpu/ops/lp_place.py``).

The greedy engines place one task (or one cohort) a step.  This flavor
solves the RELAXED assignment over the whole rows x nodes score tensor with
a fixed number of data-parallel fixed-point iterations, then repairs the
fractional solution to integrality through the greedy loop's own capacity
accounting (``ops/fused.py``: the loop with the marginals as its static
score and the open-state feasibility as its static mask, zero dynamic
weights), so binds never oversubscribe a node and the gang and queue
semantics are greedy's.

Relaxation.  ``X[t, n] >= 0`` with ``sum_n X[t, n] <= 1`` a row and, a node,
``sum_t X[t, n] * req[t, r] <= cap[n, r]`` (the pod-count room as one more
column where the pod-count gate is live); the entropy-smoothed objective
``max sum X * score - tau * sum X * log X`` over the session's own scorer
mix.  Each iteration:

1. ``z = logits + log_v``; a row's max ``m``, its lowest-index argmax and
   ``s = sum exp(z - m)``; the row's mass gate ``m > NEG / 2``;
2. ``x = exp(z - m) * ((exp(m - m) * mass) / s)``;
3. ``load = x^T @ req_aug``; a node's ``ratio = min_r cap / max(load,
   1e-9)`` over the dims with ``load > 1e-9`` (+inf where none);
4. ``log_v += log(clip(min(ratio, 1), 1e-6, 1))``; ``max |update|`` feeds
   the next iteration's ``converged_at`` test (the ``i - 1`` rule).

On CUDA tensors the iteration is ONE launch of the hand-written kernel
``csrc/lp_relax.cu`` (``lp_iterate``; the JAX package leaves it to XLA), a
persistent cooperative grid on the tiling ``lp_plan`` chooses;
on CPU tensors, or with ``lp_iterate``'s ``plain``, it is
``lp_iterate_reference``, the PyTorch operations of the JAX body.  Under signature classes
(``ops/sig_compress.py``) the rows are classes and ``req_aug`` is weighted
by each class's task count.

The knobs twin the JAX package's: ``SCHEDULER_TORCH_ALLOCATOR`` (``greedy``
or ``lp``), ``SCHEDULER_TORCH_LP_ITERS``, ``_LP_TAU``, ``_LP_TOL`` and
``_LP_LIMIT``, each in ``ops/engine_cache._ENV_KEYS``.

On a node mesh (``ops/mesh.py``; the JAX package's ``shard_map`` twins
``_lp_iterate_1d/_2d/_sig_1d/_sig_2d``) the node axis splits into blocks:
each block's rows build their logits and capacities, and an iteration
merges the blocks' ``[4, rows]`` row-stat packs (``layout.LP_PACK``) with
``sharded.merge_row_logsumexp``: ``lp_iterate_blocks``, on CUDA the same
kernel's launch over the D blocks (a node tile never crosses a block; the
rows merge over their tiles in tile order), else
``lp_iterate_blocks_reference``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.api.vocab import CPU, MEMORY
from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.layout import LP_STATS

# Finite "never" logit of an infeasible (row, node) pair: the row softmax of
# an all-infeasible row stays NaN-free, and its mass gate zeroes it.
NEG = -1e9

# Solves launched on the card (one kernel launch a solve; the CPU path never
# counts).
launches = 0

# Node-block solves launched on the card (one kernel launch a solve).
block_launches = 0

# The kernel's limits and launch shape (csrc/lp_relax.cu).
MAX_COLS = 16          # capacity columns (r_dim, plus one for the pod count)
MAX_BLOCKS = 16        # node blocks of one launch
THREADS = 512          # threads a CTA (16 warps)
WARPS = THREADS // 32
SMEM_LIMIT = 232_448   # dynamic shared memory a CTA can have on an H100


# -- knobs (all in engine_cache._ENV_KEYS) -----------------------------------------

def allocator_flavor() -> str:
    """``SCHEDULER_TORCH_ALLOCATOR``: ``greedy`` (default: the sequential
    engines) or ``lp`` (this module's relaxation and repair)."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_ALLOCATOR", "greedy", choices=("greedy", "lp"))


def lp_iters() -> int:
    """Fixed-point iterations of the relaxation (a fixed count keeps the
    output deterministic)."""
    from scheduler_tpu_torch.utils.envflags import env_int

    return env_int("SCHEDULER_TORCH_LP_ITERS", 200, minimum=1, maximum=10_000)


def lp_tau() -> float:
    """Softmax temperature: lower is sharper."""
    from scheduler_tpu_torch.utils.envflags import env_float

    return env_float("SCHEDULER_TORCH_LP_TAU", 0.25, minimum=1e-4)


def lp_tol() -> float:
    """Convergence tolerance on max |delta log_v|: evidence only (the
    iteration count stays fixed)."""
    from scheduler_tpu_torch.utils.envflags import env_float

    return env_float("SCHEDULER_TORCH_LP_TOL", 1e-3, minimum=0.0)


def lp_limit_bytes() -> int:
    """The admission gate's working-set limit in bytes (default 256 MiB)."""
    from scheduler_tpu_torch.utils.envflags import env_int

    return env_int("SCHEDULER_TORCH_LP_LIMIT", 256 * 1024 * 1024, minimum=1)


def lp_working_set_bytes(row_bucket: int, n_bucket: int, shards: int = 1) -> int:
    """The gate's working-set model a shard: about four row-by-node f32
    temporaries (logits, exponentials, marginals, feasibility), 16 bytes a
    (row, node of the block) cell."""
    return 16 * row_bucket * max(n_bucket // max(shards, 1), 1)


def lp_supported(flat_count: int, has_releasing: bool, row_bucket: int,
                 n_bucket: int, mesh=None) -> Tuple[bool, Optional[str]]:
    """Admission gate of the LP flavor: ``(ok, reason when not)``, the JAX
    gate's decisions and reasons, the flag named the port's.  Releasing capacity has no
    fractional analogue; the working set a shard (``row_bucket``: the class
    bucket under signature classes, else the task bucket; the node bucket
    over the mesh's shards) must fit the limit."""
    if flat_count == 0:
        return False, "no pending tasks"
    if has_releasing:
        return False, "releasing capacity (pipelined placements) not modeled"
    shards = mesh.size if mesh is not None else 1
    per_shard = lp_working_set_bytes(row_bucket, n_bucket, shards)
    limit = lp_limit_bytes()
    if per_shard > limit:
        return False, (
            f"[rows={row_bucket}, N={n_bucket}] working set "
            f"~{per_shard // (1024 * 1024)}MB/shard exceeds "
            f"SCHEDULER_TORCH_LP_LIMIT={limit // (1024 * 1024)}MB"
        )
    return True, None


# -- the operands --------------------------------------------------------------------

def _dynamic_score_rows(resreq, idle, allocatable, w_lr: float, w_bal: float,
                        w_bp: float) -> torch.Tensor:
    """``ops/scoring.dynamic_score`` for every request row at once: f32
    [rows, N], the same operations in the same order, over the cpu and
    memory columns the scorers read."""
    rows, n = resreq.shape[0], idle.shape[0]
    score = torch.zeros((rows, n), dtype=torch.float32, device=idle.device)
    if not (w_lr or w_bal or w_bp):
        return score
    cols = [CPU, MEMORY]
    alloc = allocatable[:, cols]
    requested = (alloc - idle[:, cols])[None, :, :] + resreq[:, None, cols]
    safe = torch.where(alloc > 0, alloc, 1.0)[None]
    if w_lr:
        frac = torch.clamp((alloc[None] - requested) / safe, 0.0, 1.0)
        score = score + w_lr * (((frac[..., 0] + frac[..., 1]) / 2.0) * 10.0)
    if w_bal or w_bp:
        frac = torch.clamp(requested / safe, 0.0, 1.0)
        if w_bal:
            score = score + w_bal * ((1.0 - (frac[..., 0] - frac[..., 1]).abs()) * 10.0)
        if w_bp:
            score = score + w_bp * (((frac[..., 0] + frac[..., 1]) / 2.0) * 10.0)
    return score


def logits_and_feasibility(idle, allocatable, task_count, pods_limit, node_gate,
                           static_mask, static_score, mins, init_resreq, resreq, *,
                           weights, tau, enforce_pod_count, use_static):
    """Open-state feasibility and the scaled score logits, ``(logits f32
    [rows, N], feas bool [rows, N])``: the epsilon fit of the init request
    against idle, the node gate, the pod-count room and the static mask;
    the dynamic scorer mix at the open ledgers plus the static score,
    divided by ``tau``, ``NEG`` where infeasible."""
    fit = ((init_resreq[:, None, :] < idle[None, :, :])
           | ((idle[None, :, :] - init_resreq[:, None, :]).abs() < mins[None, None, :])
           ).all(dim=-1)
    feas = fit & node_gate[None, :]
    if enforce_pod_count:
        feas = feas & (task_count < pods_limit)[None, :]
    score = _dynamic_score_rows(resreq, idle, allocatable, *weights)
    if use_static:
        feas = feas & static_mask
        score = score + static_score
    logits = torch.where(feas, score / np.float32(tau), np.float32(NEG))
    return logits.contiguous(), feas


def capacity(idle, task_count, pods_limit, resreq, enforce_pod_count):
    """The projection's per-node capacity columns and per-row request
    columns; the pod-count room rides as one more column (each assignment
    takes one pod slot)."""
    if enforce_pod_count:
        cap = torch.cat([idle, (pods_limit - task_count).to(idle.dtype)[:, None]], dim=1)
        req = torch.cat([resreq, torch.ones((resreq.shape[0], 1), dtype=resreq.dtype,
                                            device=resreq.device)], dim=1)
        return cap, req
    return idle, resreq


# -- the iteration: plain version and kernel ----------------------------------------------

def lp_iterate_reference(logits, cap, req_aug, *, iters: int, tol: float):
    """The fixed-point loop as PyTorch operations in the JAX body's order
    (``scheduler_tpu/ops/lp_place.py:223-256``), on one device: ``(x f32
    [rows, N], pref i32 [rows], lp_raw i32 [2])``, the marginals and the
    preferred nodes of the last iteration."""
    dev = logits.device
    log_v = torch.zeros(logits.shape[1], dtype=torch.float32, device=dev)
    gupd = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    conv = torch.tensor(-1, dtype=torch.int32, device=dev)
    x = pref = None
    for i in range(iters):
        z = logits + log_v[None, :]
        m = z.max(dim=1).values
        e = torch.exp(z - m[:, None])
        s = e.sum(dim=1)
        pref = torch.argmax(z, dim=1)
        mass = (m > np.float32(NEG * 0.5)).to(torch.float32)
        x = e * (torch.exp(m - m) * mass / s)[:, None]
        if i > 0:
            conv = torch.where((gupd < np.float32(tol)) & (conv < 0),
                               torch.tensor(i - 1, dtype=torch.int32, device=dev), conv)
        if i == iters - 1:
            break
        load = x.T @ req_aug
        ratio = torch.where(load > np.float32(1e-9),
                            cap / torch.clamp(load, min=np.float32(1e-9)),
                            torch.tensor(float("inf"), device=dev)).min(dim=1).values
        scale = torch.clamp(torch.clamp(ratio, max=1.0), np.float32(1e-6), 1.0)
        upd = torch.log(scale)
        log_v = log_v + upd
        gupd = upd.abs().max()
    lp_raw = torch.zeros(2, dtype=torch.int32, device=dev)
    lp_raw[LP_STATS.ITERATIONS] = iters
    lp_raw[LP_STATS.CONVERGED_AT] = conv
    return x, pref.to(torch.int32), lp_raw


# -- the kernel's launch plan ------------------------------------------------------

@dataclass(frozen=True)
class LpPlan:
    """The launch plan of ``csrc/lp_relax.cu`` for a [rows, d * n] plane of
    ``r`` capacity columns.

    ``mode`` ``rows``: CTA c owns rows [c * tr, ...) over every block's
    nodes (its rows' merge is local), ``batch`` rows at a time through
    shared memory, a warp a row, and projects the c-th run of
    ``ceil(d * n / ctas)`` global nodes.  ``tiles``: CTA c owns row tile c // NT and node tile t = c %
    NT (NT = d * node_tiles; block t // node_tiles, nodes from (t %
    node_tiles) * tn, at most tn of them); the rows merge their tiles'
    statistics in tile order after a grid barrier, and every CTA of a node
    tile projects that tile.  ``l_rows`` rows of a CTA's logits stay in
    shared memory (the rest are read from L2 each iteration); in tiles mode
    ``e_rows`` rows of the tile's exponentials are on chip and the rest in
    a global scratch of ``spill`` floats a CTA.  The running loads (rows
    mode), the projection's stage of partial loads (in the exponentials'
    region, ``stage_nodes`` nodes at a time) and the request rows
    (``off_req``, padded to the kernel's column count) are float64.
    Offsets are in floats of dynamic shared memory."""
    mode: str
    rows: int
    n: int
    r: int
    d: int
    ctas: int
    tr: int
    row_tiles: int
    tn: int
    node_tiles: int
    batch: int
    l_rows: int
    e_rows: int
    stage_nodes: int
    smem_bytes: int
    off_lv: int
    off_acc: int
    off_e: int
    off_stat: int
    off_req: int
    off_l: int
    spill: int
    sms: int

    @property
    def resident(self) -> bool:
        """One CTA an SM: the grid fits the card at once."""
        return self.ctas <= self.sms


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _a4(v: int) -> int:
    return _ceil(v, 4) * 4


def _rm(r: int) -> int:
    """The column count the kernel is built for that holds ``r``."""
    return 2 if r <= 2 else 4 if r <= 4 else 8 if r <= 8 else 16


def _plan_for(mode, rows, n, r, d, sms, tr, tn, batch=None, l_rows=None, e_rows=None):
    """The plan of one tiling, or None where its fixed regions do not fit a
    CTA's shared memory (a forced ``batch``, ``l_rows`` or ``e_rows`` that
    does not fit raises)."""
    rt = _ceil(rows, tr)
    room = SMEM_LIMIT // 4
    # The float64 regions (the running loads, the projection's stage of
    # partial loads, the request rows, padded to the kernel's RM columns)
    # take two floats an entry.  The stage holds every node the CTA projects
    # where that fits, else one.
    rm = _rm(r)
    proj = _ceil(d * n, rt) if mode == "rows" else min(tn, n)
    stage_one, stage_all = _a4(2 * rt * r), _a4(2 * rt * r * proj)
    if mode == "rows":
        w = d * n
        tn, ntb, ctas = n, 1, rt
        lv, acc = _a4(w), _a4(2 * r * w)

        def rest(b, stage):
            return lv + acc + max(_a4(b * w), stage) + _a4(4 * b * d) + _a4(2 * b * rm)

        fits = [b for b in ([batch] if batch else range(min(tr, WARPS), 0, -1))
                if rest(b, stage_one) <= room]
        if not fits:
            if batch:
                raise ValueError(f"lp_plan: a batch of {batch} rows x {w} nodes does not fit")
            return None
        batch = fits[0]
        stage = stage_all if rest(batch, stage_all) <= room else stage_one
        e = max(_a4(batch * w), stage)
        stat = _a4(4 * batch * d)
        req = _a4(2 * batch * rm)
        e_rows = 0
    else:
        ntb = _ceil(n, tn)
        nt = d * ntb
        w, ctas, batch = tn, rt * nt, tr
        lv, acc = _a4(tn), 0
        stat = _a4(2 * tr + WARPS * nt)
        req = _a4(2 * tr * rm)
        if lv + stat + req + stage_one > room:
            return None
        stage = stage_all if lv + stat + req + stage_all <= room else stage_one
        e_rows = (min(tr, (room - lv - stat - req) // tn) if e_rows is None
                  else min(e_rows, tr))
        e = max(_a4(e_rows * tn), stage)
        if lv + e + stat + req > room:
            raise ValueError(f"lp_plan: {e_rows} rows of exponentials x {tn} nodes do not fit")
    fixed = lv + acc + e + stat + req
    if l_rows is None:
        l_rows = min(tr, (room - fixed) // w)
    if fixed + l_rows * w > room:
        raise ValueError(f"lp_plan: {l_rows} logits rows x {w} nodes do not fit")
    off_acc = lv
    off_e = off_acc + acc
    off_stat = off_e + e
    off_req = off_stat + stat
    off_l = off_req + req
    return LpPlan(mode=mode, rows=rows, n=n, r=r, d=d, ctas=ctas, tr=tr, row_tiles=rt, tn=tn,
                  node_tiles=ntb, batch=batch, l_rows=l_rows, e_rows=e_rows,
                  stage_nodes=e // (2 * rt * r), smem_bytes=4 * (off_l + l_rows * w),
                  off_lv=0,
                  off_acc=off_acc, off_e=off_e, off_stat=off_stat, off_req=off_req, off_l=off_l,
                  spill=(tr - e_rows) * tn if mode == "tiles" else 0, sms=sms)


def lp_plan(rows: int, n: int, r: int, d: int = 1, sms: int = 132, *,
            mode: Optional[str] = None, tr: Optional[int] = None, tn: Optional[int] = None,
            batch: Optional[int] = None, l_rows: Optional[int] = None,
            e_rows: Optional[int] = None) -> LpPlan:
    """The kernel's plan for ``rows`` rows over ``d`` blocks of ``n`` nodes
    and ``r`` capacity columns on a card of ``sms`` SMs.  By default: whole
    rows, ``ceil(rows / sms)`` a CTA, wherever that plan fits; else, of the
    tilings into tiles of a power of two from 32 nodes (or a block's whole
    ``n``) with at most ``sms`` node tiles and as many row tiles as leave
    at most ``sms`` CTAs, the one with the most CTAs, ties to the fewest
    row tiles (each row tile repeats its node tile's projection).  The
    rule is the one forced plans showed on the card (``scripts/lp_ab.py``):
    whole rows ran faster than any tiling at every shape where both fit
    (r', v, 66 to 4,224 rows over 1,024 nodes), and at r, where whole rows
    do not fit, the tiling of the most CTAs and one row tile was within the
    noise of the fastest.  Each argument after ``sms`` forces that part of
    the plan (the tests use them); a forced plan may ask for more CTAs than
    can be resident (the launch then raises)."""
    if rows < 1 or n < 1 or d < 1 or not 1 <= r <= MAX_COLS:
        raise ValueError(f"lp_plan: [{rows} x {d} x {n}] with {r} columns")
    if mode not in (None, "rows", "tiles"):
        raise ValueError(f"lp_plan: mode {mode!r} (rows or tiles)")
    force = dict(batch=batch, l_rows=l_rows, e_rows=e_rows)
    plans = []
    if mode in (None, "rows") and tn is None:
        p = _plan_for("rows", rows, n, r, d, sms, tr or _ceil(rows, sms),
                      None, batch=batch, l_rows=l_rows)
        if p is not None:
            plans.append(p)
    if mode in (None, "tiles"):
        widths = [tn] if tn else sorted({min(1 << k, n) for k in range(5, 31) if (1 << k) < 2 * n})
        for width in widths:
            nt = d * _ceil(n, width)
            if tr is None and nt > sms:
                continue
            t = tr or _ceil(rows, max(1, min(rows, sms // nt)))
            p = _plan_for("tiles", rows, n, r, d, sms, t, width, **force)
            if p is not None:
                plans.append(p)
    if not plans:
        raise ValueError(f"lp_plan: no {mode or 'rows or tiles'} plan for [{rows} x {d} x {n}]")
    return min(plans, key=lambda p: (not p.resident, p.mode != "rows", -p.ctas, p.row_tiles))


# -- the kernel's launch ---------------------------------------------------------------

PHASES = ("tile_stats", "tile_merge", "load_partials", "projection", "grid_barriers",
          "log_v_reload")
ERR_PLAN, ERR_NOT_RESIDENT = 10001, 10002


class _LpArgs(ctypes.Structure):
    """Mirror of ``struct LpArgs`` in ``csrc/lp_relax.cu``."""

    _fields_ = ([(name, ctypes.c_void_p * MAX_BLOCKS) for name in ("logits", "cap", "x")]
                + [(name, ctypes.c_void_p) for name in (
                    "req", "log_v", "partial", "stat_m", "stat_s", "stat_a", "spill", "state",
                    "pref", "lp_raw", "clocks")]
                + [(name, ctypes.c_int) for name in ("rows", "n", "r", "d", "iters")]
                + [("tol", ctypes.c_float)]
                + [(name, ctypes.c_int) for name in (
                    "mode", "ctas", "tr", "row_tiles", "tn", "node_tiles", "batch", "l_rows",
                    "e_rows", "stage_nodes", "smem_bytes", "off_lv", "off_acc", "off_e",
                    "off_stat", "off_req", "off_l")])


_sms_of: dict = {}


def device_sms(dev) -> int:
    """The SM count of CUDA device ``dev``."""
    idx = torch.device(dev).index or 0
    if idx not in _sms_of:
        _sms_of[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms_of[idx]


def _entry(lib, blocks: bool):
    fn = lib.lp_relax_blocks_launch if blocks else lib.lp_relax_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _solve(logits_b, cap_b, req_aug, *, iters, tol, plan=None, blocks=False, lib=None,
           clocks=None):
    """One launch of the kernel on CUDA blocks that share one device:
    ``(x blocks, pref, lp_raw)``.  ``lib``: another build of the kernel
    (``cuda_build.load_variant``); ``clocks``: its phase clocks' int64
    output (an ``LP_PHASE_CLOCKS`` build)."""
    d = len(logits_b)
    dev = logits_b[0].device
    rows, n = logits_b[0].shape
    r = cap_b[0].shape[1]
    if plan is None:
        plan = lp_plan(rows, n, r, d, device_sms(dev))
    if (plan.rows, plan.n, plan.r, plan.d) != (rows, n, r, d):
        raise ValueError(f"lp_relax: a plan for [{plan.rows} x {plan.d} x {plan.n}] x "
                         f"{plan.r} on [{rows} x {d} x {n}] x {r}")
    f32 = torch.float32
    wtot = d * n
    x_b = [torch.empty((rows, n), dtype=f32, device=dev) for _ in range(d)]
    pref = torch.empty(rows, dtype=torch.int32, device=dev)
    lp_raw = torch.empty(2, dtype=torch.int32, device=dev)
    partial = torch.empty((plan.row_tiles, r, wtot), dtype=torch.float64, device=dev)
    state = torch.empty(2 + iters, dtype=torch.int32, device=dev)
    keep = [partial, state]
    args = _LpArgs()
    for k in range(d):
        args.logits[k] = logits_b[k].data_ptr()
        args.cap[k] = cap_b[k].data_ptr()
        args.x[k] = x_b[k].data_ptr()
    args.req = req_aug.data_ptr()
    args.partial = partial.data_ptr()
    args.state = state.data_ptr()
    args.pref = pref.data_ptr()
    args.lp_raw = lp_raw.data_ptr()
    args.clocks = clocks.data_ptr() if clocks is not None else None
    if plan.mode == "rows":
        log_v = torch.empty(wtot, dtype=f32, device=dev)
        keep.append(log_v)
        args.log_v = log_v.data_ptr()
    else:
        nt = d * plan.node_tiles
        stats = torch.empty((2, rows, nt), dtype=f32, device=dev)
        stat_a = torch.empty((rows, nt), dtype=torch.int32, device=dev)
        keep += [stats, stat_a]
        args.stat_m, args.stat_s = stats[0].data_ptr(), stats[1].data_ptr()
        args.stat_a = stat_a.data_ptr()
        if plan.spill:
            spill = torch.empty(plan.ctas * plan.spill, dtype=f32, device=dev)
            keep.append(spill)
            args.spill = spill.data_ptr()
    args.rows, args.n, args.r, args.d, args.iters = rows, n, r, d, int(iters)
    args.tol = float(tol)
    args.mode = 0 if plan.mode == "rows" else 1
    for name in ("ctas", "tr", "row_tiles", "tn", "node_tiles", "batch", "l_rows", "e_rows",
                 "stage_nodes", "smem_bytes", "off_lv", "off_acc", "off_e", "off_stat", "off_req",
                 "off_l"):
        setattr(args, name, getattr(plan, name))
    fn = _entry(lib if lib is not None else cuda_build.load(), blocks)
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc == ERR_NOT_RESIDENT:
        raise RuntimeError(f"lp_relax launch refused: the plan's {plan.ctas} CTAs cannot all be "
                           f"resident on the card")
    if rc == ERR_PLAN:
        raise RuntimeError(f"lp_relax launch refused: the kernel does not take the plan {plan}")
    if rc != 0:
        raise RuntimeError(f"lp_relax launch failed: CUDA error {rc}")
    return x_b, pref, lp_raw


def lp_iterate(logits, cap, req_aug, *, iters: int, tol: float, plain: bool = False,
               plan: Optional[LpPlan] = None):
    """The fixed-point loop: ``(x f32 [rows, N], pref i32 [rows], lp_raw i32
    [2])``.  CPU tensors, or ``plain``, run ``lp_iterate_reference``; CUDA
    tensors launch ``csrc/lp_relax.cu`` once (``launches`` + 1) on ``plan``
    (default ``lp_plan``'s) or raise."""
    if plain or logits.device.type == "cpu":
        return lp_iterate_reference(logits, cap, req_aug, iters=iters, tol=tol)
    return _launch(logits, cap, req_aug, iters=iters, tol=tol, plan=plan)


def _launch(logits, cap, req_aug, *, iters, tol, plan=None):
    global launches
    rows, n = logits.shape
    r = cap.shape[1]
    dev = logits.device
    f32 = torch.float32
    if r < 1 or r > MAX_COLS:
        raise ValueError(f"lp_relax: {r} capacity columns (1 to {MAX_COLS})")
    if iters < 1:
        raise ValueError("lp_relax: iters must be at least 1")
    for name, t, shape in (("logits", logits, (rows, n)), ("cap", cap, (n, r)),
                           ("req_aug", req_aug, (rows, r))):
        if t.device.type != "cuda" or t.device != dev or t.dtype != f32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"lp_relax: {name} must be a CUDA float32 tensor of shape {shape}")
        if not t.is_contiguous():
            raise ValueError(f"lp_relax: {name} must be contiguous")
    x_b, pref, lp_raw = _solve([logits], [cap], req_aug, iters=iters, tol=tol, plan=plan)
    launches += 1
    return x_b[0], pref, lp_raw


def lp_relax(idle, allocatable, task_count, pods_limit, node_gate, static_mask, static_score,
             mins, init_resreq, resreq, class_count=None, *, iters: int, tau: float,
             tol: float, weights, enforce_pod_count: bool, use_static: bool, mesh=None):
    """Solve the relaxed assignment (``scheduler_tpu/ops/lp_place.py::
    lp_relax``).  Returns ``(marginals f32 [rows, N], feasibility bool
    [rows, N], pref i32 [rows], lp_raw i32 [2])``: the rows slot into the
    repair's static positions.  ``class_count`` f32 [rows]: the rows are
    signature classes and each row's load in the projection is weighted by
    its task count (a marginal row stays a per-task distribution).  With
    ``mesh`` the node operands (whole, or ``ops/mesh.py`` Sharded) split
    into the mesh's blocks, the marginals and the feasibility come back as
    node-trailing ``Sharded`` blocks and ``pref`` / ``lp_raw`` whole on the
    mesh's first device."""
    if mesh is not None:
        return _lp_relax_blocks(idle, allocatable, task_count, pods_limit, node_gate,
                                static_mask, static_score, mins, init_resreq, resreq,
                                class_count, iters=iters, tau=tau, tol=tol, weights=weights,
                                enforce_pod_count=enforce_pod_count, use_static=use_static,
                                mesh=mesh)
    logits, feas = logits_and_feasibility(
        idle, allocatable, task_count, pods_limit, node_gate, static_mask, static_score,
        mins, init_resreq, resreq, weights=weights, tau=tau,
        enforce_pod_count=enforce_pod_count, use_static=use_static)
    cap, req_aug = capacity(idle, task_count, pods_limit, resreq, enforce_pod_count)
    if class_count is not None:
        req_aug = req_aug * class_count[:, None]
    x, pref, lp_raw = lp_iterate(logits, cap.contiguous(), req_aug.contiguous(), iters=iters,
                                 tol=tol)
    return x, feas, pref, lp_raw


# -- node blocks -------------------------------------------------------------------

def lp_iterate_blocks_reference(logits_b, cap_b, req_aug, *, iters: int, tol: float):
    """The fixed-point loop over node blocks in PyTorch operations (the JAX
    ``_iterate_block`` with ``merge_row_logsumexp``): ``logits_b`` /
    ``cap_b`` one tensor a block (block k's first global node is k * n),
    ``req_aug`` the rows' capacity columns.  Returns ``(x blocks, pref i32
    [rows], lp_raw i32 [2])``, ``pref`` and ``lp_raw`` on the first block's
    device."""
    from scheduler_tpu_torch.ops.sharded import merge_row_logsumexp

    d = len(logits_b)
    first = logits_b[0].device
    n = logits_b[0].shape[1]
    rows = logits_b[0].shape[0]
    f32 = torch.float32
    log_v = [torch.zeros(n, dtype=f32, device=lb.device) for lb in logits_b]
    req_b = [req_aug.to(lb.device) for lb in logits_b]
    gupd = [torch.tensor(float("inf"), dtype=f32, device=lb.device) for lb in logits_b]
    conv = -1
    x_b = pref = None
    for i in range(iters):
        packs, e_b, m_b = [], [], []
        for k in range(d):
            z = logits_b[k] + log_v[k][None, :]
            m_l = z.max(dim=1).values
            e = torch.exp(z - m_l[:, None])
            s_l = e.sum(dim=1)
            am = (torch.argmax(z, dim=1) + k * n).to(f32)
            packs.append(torch.stack([m_l, s_l, am, gupd[k].expand(rows)]).to(first))
            e_b.append(e)
            m_b.append(m_l)
        m, s, pref_f, upd_max = merge_row_logsumexp(torch.stack(packs))
        pref = pref_f
        mass = (m > np.float32(NEG * 0.5)).to(f32)
        if i > 0 and float(upd_max) < np.float32(tol) and conv < 0:
            conv = i - 1
        x_b = []
        for k in range(d):
            dev = logits_b[k].device
            coef = torch.exp(m_b[k] - m.to(dev)) * mass.to(dev) / s.to(dev)
            x_b.append(e_b[k] * coef[:, None])
        if i == iters - 1:
            break
        for k in range(d):
            load = x_b[k].T @ req_b[k]
            ratio = torch.where(load > np.float32(1e-9),
                                cap_b[k] / torch.clamp(load, min=np.float32(1e-9)),
                                torch.tensor(float("inf"), device=load.device)).min(dim=1).values
            scale = torch.clamp(torch.clamp(ratio, max=1.0), np.float32(1e-6), 1.0)
            upd = torch.log(scale)
            log_v[k] = log_v[k] + upd
            gupd[k] = upd.abs().max()
    lp_raw = torch.zeros(2, dtype=torch.int32, device=first)
    lp_raw[LP_STATS.ITERATIONS] = iters
    lp_raw[LP_STATS.CONVERGED_AT] = conv
    return x_b, pref.to(torch.int32), lp_raw


def lp_iterate_blocks(logits_b, cap_b, req_aug, *, iters: int, tol: float,
                      plain: bool = False, plan: Optional[LpPlan] = None):
    """The fixed-point loop over node blocks: ``(x blocks, pref i32 [rows],
    lp_raw i32 [2])``.  CPU blocks, or ``plain``, run
    ``lp_iterate_blocks_reference``; CUDA blocks launch ``csrc/lp_relax.cu``
    once over all of them (``block_launches`` + 1) on ``plan`` (default
    ``lp_plan``'s) or raise.  The launch runs every block on the first
    block's device: blocks elsewhere are copied there and their marginals
    copied back by the caller."""
    if plain or logits_b[0].device.type == "cpu":
        return lp_iterate_blocks_reference(logits_b, cap_b, req_aug, iters=iters, tol=tol)
    global block_launches
    d = len(logits_b)
    dev = logits_b[0].device
    rows, n = logits_b[0].shape
    r = cap_b[0].shape[1]
    f32 = torch.float32
    if r < 1 or r > MAX_COLS:
        raise ValueError(f"lp_relax: {r} capacity columns (1 to {MAX_COLS})")
    if not 1 <= d <= MAX_BLOCKS:
        raise ValueError(f"lp_relax: {d} node blocks (1 to {MAX_BLOCKS})")
    if iters < 1:
        raise ValueError("lp_relax: iters must be at least 1")
    logits_b = [lb.to(dev).contiguous() for lb in logits_b]
    cap_b = [cb.to(dev).contiguous() for cb in cap_b]
    req_aug = req_aug.to(dev).contiguous()
    for k in range(d):
        for name, t, shape in (("logits", logits_b[k], (rows, n)), ("cap", cap_b[k], (n, r))):
            if t.dtype != f32 or tuple(t.shape) != shape:
                raise ValueError(f"lp_relax: block {k}'s {name} must be float32 {shape}")
    if req_aug.dtype != f32 or tuple(req_aug.shape) != (rows, r):
        raise ValueError(f"lp_relax: req_aug must be float32 {(rows, r)}")
    out = _solve(logits_b, cap_b, req_aug, iters=iters, tol=tol, plan=plan, blocks=True)
    block_launches += 1
    return out


def _lp_relax_blocks(idle, allocatable, task_count, pods_limit, node_gate, static_mask,
                     static_score, mins, init_resreq, resreq, class_count, *, iters, tau, tol,
                     weights, enforce_pod_count, use_static, mesh):
    """``lp_relax`` over the mesh's node blocks (the JAX ``shard_fn``): each
    block's logits, feasibility and capacities from its own rows, then
    ``lp_iterate_blocks``."""
    from scheduler_tpu_torch.ops.mesh import Sharded, family_on

    def blocks(a, axis):
        if isinstance(a, Sharded):
            return a.shards
        return Sharded.split(mesh, a, axis, "").shards

    idle_b, alloc_b, tc_b = blocks(idle, 0), blocks(allocatable, 0), blocks(task_count, 0)
    plim_b, gate_b = blocks(pods_limit, 0), blocks(node_gate, 0)
    if use_static:
        smask_b, sscore_b = blocks(static_mask, 1), blocks(static_score, 1)
    logits_b, feas_b, cap_b = [], [], []
    req_aug = None
    for k, dev in enumerate(mesh.devices):
        n_local = idle_b[k].shape[0]
        sm = smask_b[k] if use_static else torch.ones((1, n_local), dtype=torch.bool,
                                                      device=dev)
        ss = sscore_b[k] if use_static else torch.zeros((1, n_local), dtype=torch.float32,
                                                        device=dev)
        logits, feas = logits_and_feasibility(
            idle_b[k], alloc_b[k], tc_b[k], plim_b[k], gate_b[k], sm, ss, mins.to(dev),
            init_resreq.to(dev), resreq.to(dev), weights=weights, tau=tau,
            enforce_pod_count=enforce_pod_count, use_static=use_static)
        cap, req_k = capacity(idle_b[k], tc_b[k], plim_b[k], resreq.to(dev), enforce_pod_count)
        if class_count is not None:
            req_k = req_k * class_count.to(dev)[:, None]
        if req_aug is None:
            req_aug = req_k.contiguous()
        logits_b.append(logits)
        feas_b.append(feas)
        cap_b.append(cap.contiguous())
    x_b, pref, lp_raw = lp_iterate_blocks(logits_b, cap_b, req_aug, iters=iters, tol=tol)
    fam = family_on(mesh, "node_trailing")
    x_b = [x.to(dev) for x, dev in zip(x_b, mesh.devices)]
    return (Sharded(mesh, x_b, 1, fam), Sharded(mesh, feas_b, 1, fam), pref.to(mesh.first),
            lp_raw.to(mesh.first))


# -- host-side evidence ------------------------------------------------------------

def lp_stats_dict(lp_raw: np.ndarray) -> dict:
    """Decode the evidence row (``converged_at`` -1: the projection never
    fell under the tolerance)."""
    return {
        "iterations": int(lp_raw[LP_STATS.ITERATIONS]),
        "converged_at": int(lp_raw[LP_STATS.CONVERGED_AT]),
    }


def lp_quality(codes: np.ndarray, pref: np.ndarray, resreq: np.ndarray,
               idle_open: np.ndarray, job_idx: np.ndarray, allocatable: np.ndarray) -> dict:
    """The cycle's quality block (``scheduler_tpu/ops/lp_place.py:530-582``):
    ``binds``; ``repair_fallbacks``, placed pods whose node differs from
    their preferred node; ``fragmentation``, 1 - (copies of the mean placed
    request that fit node by node after the cycle) / (copies if the same
    leftover were consolidated); ``drf_distance``, max minus mean of the
    placed jobs' dominant shares of this cycle's placements."""
    placed = codes >= 0
    binds = int(placed.sum())
    out = {
        "binds": binds,
        "repair_fallbacks": int((placed & (codes != pref)).sum()),
    }
    n, r = idle_open.shape
    load = np.zeros((n, r))
    if binds:
        np.add.at(load, codes[placed], resreq[placed])
    idle_after = np.maximum(idle_open - load, 0.0)
    ref_req = resreq[placed].mean(axis=0) if binds else (
        resreq.mean(axis=0) if resreq.shape[0] else np.zeros(r)
    )
    pos = ref_req > 0
    if pos.any() and n:
        per_node = np.floor(np.min(idle_after[:, pos] / ref_req[pos][None, :], axis=1))
        ideal = np.floor(np.min(idle_after[:, pos].sum(axis=0) / ref_req[pos]))
        out["fragmentation"] = (
            round(float(1.0 - per_node.sum() / ideal), 4) if ideal > 0 else 0.0
        )
    else:
        out["fragmentation"] = 0.0
    totals = allocatable.sum(axis=0) if n else np.zeros(r)
    safe = np.where(totals > 0, totals, 1.0)
    if binds and job_idx.size:
        nj = int(job_idx.max()) + 1
        job_load = np.zeros((nj, r))
        np.add.at(job_load, job_idx[placed], resreq[placed])
        dom = (job_load / safe[None, :] * (totals > 0)[None, :]).max(axis=1)
        dom = dom[np.unique(job_idx[placed])]
        out["drf_distance"] = round(float(dom.max() - dom.mean()), 6)
    else:
        out["drf_distance"] = 0.0
    return out
