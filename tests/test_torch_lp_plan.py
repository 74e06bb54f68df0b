"""The launch plan of the ``lp_relax`` kernel (``lp_place.lp_plan``) and its
summation order, on the CPU.

* ``lp_plan`` at the shapes of paths r' (config 2 under LP, [8,192 x 1,024],
  three capacity columns), r (the flagship's 16 classes x 16,384 nodes, two
  columns), v (r''s logits over node blocks) and every
  ``chip_smoke.LP_KERNEL_CASES`` case, over 1, 2 and 4 blocks: the tiles
  cover the plane exactly once, no node tile crosses a block, the
  projection takes every node, the shared-memory regions fit a CTA and
  do not overlap, and the grid is no larger than the card's resident
  count (one CTA an SM);
* ``kernel_order_relax``, the kernel's arithmetic in PyTorch in the
  kernel's order (tile statistics, the rows' merge over their tiles in
  tile order, each row tile's load partials in ascending rows, then the
  row tiles in four interleaved sums, the loads in float64), against the
  JAX ``lp_relax``
  on the CPU as
  ``tests/test_torch_lp_place.py``'s parity tests run it: the marginals
  within that file's ``MARGINAL_ATOL``, ``pref`` and the evidence row
  equal, for the plan's own tiling and for forced ones; on tight
  class-weighted rows at 16 columns, where float32 alone moves every
  version past the card's limit from the float64 solve, the kernel's order
  within that limit of JAX's marginals.
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from scheduler_tpu_torch.ops import lp_place
from scheduler_tpu_torch.ops.lp_place import lp_plan

H100_SMS = 132

# tests/test_torch_lp_place.py's limit of the plain relaxation against JAX's.
MARGINAL_ATOL = 1e-4

# (rows, nodes over all blocks, capacity columns) of the main paths.
PATH_SHAPES = {"r'": (8192, 1024, 3), "r": (16, 16384, 2), "v": (8192, 1024, 3)}


def _case_shapes():
    out = dict(PATH_SHAPES)
    for name, (_, rows, n, r_dim, _, pod_count, *_rest) in smoke.LP_KERNEL_CASES.items():
        out[name] = (rows, n, r_dim + (1 if pod_count else 0))
    return out


SHAPES = _case_shapes()


def lp_tiles(plan):
    """The plane as the kernel cuts it (``csrc/lp_relax.cu``): one ``(cta,
    row0, nrows, block, j0, nodes)`` a CTA and block segment it owns."""
    out = []
    for cta in range(plan.ctas):
        if plan.mode == "rows":
            row0 = cta * plan.tr
            for k in range(plan.d):
                out.append((cta, row0, min(plan.tr, plan.rows - row0), k, 0, plan.n))
        else:
            nt = plan.d * plan.node_tiles
            rt, t = divmod(cta, nt)
            k, tt = divmod(t, plan.node_tiles)
            row0, j0 = rt * plan.tr, tt * plan.tn
            out.append((cta, row0, min(plan.tr, plan.rows - row0), k, j0,
                        min(plan.tn, plan.n - j0)))
    return out


def lp_projection_nodes(plan):
    """The global nodes [p0, p1) each CTA projects, as the kernel splits
    them (tiles mode: its node tile, the same for every row tile)."""
    w = plan.d * plan.n
    if plan.mode == "rows":
        per = -(-w // plan.ctas)
        return [(min(c * per, w), min(c * per + per, w)) for c in range(plan.ctas)]
    return [(k * plan.n + j0, k * plan.n + j0 + nw) for _, _, _, k, j0, nw in lp_tiles(plan)]


def _check_plan(plan, rows, n, r, d):
    """The plan's invariants (module docstring)."""
    assert (plan.rows, plan.n, plan.r, plan.d) == (rows, n, r, d)
    cover = np.zeros((rows, d * n), np.int32)
    for _, row0, nrows, k, j0, nw in lp_tiles(plan):
        assert nrows >= 1 and nw >= 1
        assert 0 <= j0 and j0 + nw <= n, "a node tile crosses a block"
        cover[row0:row0 + nrows, k * n + j0:k * n + j0 + nw] += 1
    assert (cover == 1).all(), "the tiles do not cover the plane exactly once"
    proj = np.zeros(d * n, np.int32)
    spans = lp_projection_nodes(plan)
    if plan.mode == "tiles":
        # Every row tile's CTAs project their node tile: one row tile's do.
        spans = spans[:d * plan.node_tiles]
    for p0, p1 in spans:
        proj[p0:p1] += 1
    assert (proj == 1).all()
    w = d * n if plan.mode == "rows" else plan.tn
    offsets = (plan.off_lv, plan.off_acc, plan.off_e, plan.off_stat, plan.off_req, plan.off_l)
    assert offsets[0] == 0 and list(offsets) == sorted(offsets)
    assert all(o % 4 == 0 for o in offsets), "a region off its 16-byte alignment"
    assert plan.off_acc - plan.off_lv >= w
    # float64 regions: two floats an entry
    assert plan.off_e - plan.off_acc >= (2 * r * w if plan.mode == "rows" else 0)
    e_floats = plan.off_stat - plan.off_e
    rows_held = plan.batch if plan.mode == "rows" else plan.tr
    rm = 2 if r <= 2 else 4 if r <= 4 else 8 if r <= 8 else 16
    assert plan.off_l - plan.off_req >= 2 * rows_held * rm
    if plan.mode == "rows":
        assert e_floats >= plan.batch * w and plan.off_req - plan.off_stat >= 4 * plan.batch * d
        assert 1 <= plan.batch <= plan.tr
    else:
        assert e_floats >= plan.e_rows * w and plan.e_rows <= plan.tr
        assert plan.off_req - plan.off_stat >= 2 * plan.tr + lp_place.WARPS * d * plan.node_tiles
        assert plan.spill == (plan.tr - plan.e_rows) * plan.tn
    assert plan.stage_nodes >= 1 and 2 * plan.stage_nodes * plan.row_tiles * r <= e_floats
    assert 0 <= plan.l_rows <= plan.tr
    assert plan.smem_bytes == 4 * (plan.off_l + plan.l_rows * w)
    assert plan.smem_bytes <= 232_448
    assert plan.row_tiles == -(-rows // plan.tr)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_default_plan_covers_fits_and_is_resident(shape, d):
    rows, n_all, r = SHAPES[shape]
    n = -(-n_all // d)
    plan = lp_plan(rows, n, r, d, H100_SMS)
    _check_plan(plan, rows, n, r, d)
    assert plan.resident and plan.ctas <= H100_SMS


def test_main_path_plans():
    """r' and v: whole rows (the merge is local), 63 rows a CTA, 33 of
    them on chip; r: 16 x 128 tiles on 128 CTAs (one row tile), everything
    on chip."""
    rp = lp_plan(8192, 1024, 3, 1, H100_SMS)
    v = lp_plan(8192, 256, 3, 4, H100_SMS)
    r = lp_plan(16, 16384, 2, 1, H100_SMS)
    for p in (rp, v):
        assert (p.mode, p.ctas, p.tr, p.batch, p.l_rows) == ("rows", 131, 63, 16, 33)
    assert (r.mode, r.ctas, r.tr, r.tn, r.l_rows, r.e_rows) == ("tiles", 128, 16, 128, 16, 16)


FORCED = {
    "rows_batch1_offchip": dict(mode="rows", batch=1, l_rows=0),
    "rows_tr3": dict(mode="rows", tr=3),
    "tiles_32": dict(mode="tiles", tn=32),
    "tiles_64_spill": dict(mode="tiles", tn=64, tr=40, l_rows=1, e_rows=3),
    "tiles_whole_block": dict(mode="tiles", tn=4096),
}


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("force", sorted(FORCED))
def test_forced_plans_cover_and_fit(force, d):
    for shape in ("chunks", "small", "one_row", "dims9"):
        rows, n_all, r = SHAPES[shape]
        n = -(-n_all // d)
        plan = lp_plan(rows, n, r, d, H100_SMS, **FORCED[force])
        _check_plan(plan, rows, n, r, d)


def test_forced_plan_past_the_resident_count():
    plan = lp_plan(300, 257, 3, 1, H100_SMS, mode="tiles", tn=32, tr=1)
    _check_plan(plan, 300, 257, 3, 1)
    assert plan.ctas == 300 * 9 and not plan.resident


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        lp_plan(16, 20000, 2, 1, H100_SMS, mode="rows")
    with pytest.raises(ValueError):
        lp_plan(16, 64, 2, 1, H100_SMS, mode="rows", batch=1, l_rows=10**6)
    with pytest.raises(ValueError):
        lp_plan(16, 64, lp_place.MAX_COLS + 1, 1, H100_SMS)


# -- the kernel's summation order -------------------------------------------------------

def kernel_order_relax(logits_b, cap_b, req_aug, plan, *, iters, tol):
    """The kernel's function (``csrc/lp_relax.cu``) on CPU tensors in its
    order of summation on ``plan``: ``(x blocks, pref, lp_raw)``.  Within
    a tile the row max and sum are torch's; across tiles, rows and row
    tiles the order is the kernel's."""
    f32 = torch.float32
    d = len(logits_b)
    rows, n = logits_b[0].shape
    r = req_aug.shape[1]
    tn = n if plan.mode == "rows" else plan.tn
    spans = [(k, j0, min(tn, n - j0)) for k in range(d) for j0 in range(0, n, tn)]
    rt_n, tr = plan.row_tiles, plan.tr
    log_v = [torch.zeros(n, dtype=f32) for _ in range(d)]
    gmax = []
    x_b = pref = None
    for it in range(iters):
        m_t, s_t, a_t, e_t = [], [], [], []
        for k, j0, nw in spans:
            z = logits_b[k][:, j0:j0 + nw] + log_v[k][j0:j0 + nw][None, :]
            m = z.max(dim=1).values
            e = torch.exp(z - m[:, None])
            m_t.append(m)
            s_t.append(e.sum(dim=1))
            a_t.append(torch.argmax(z, dim=1) + k * n + j0)
            e_t.append(e)
        mt = torch.stack(m_t)
        star = torch.argmax(mt, dim=0)
        m = mt.max(dim=0).values
        pref = torch.stack(a_t).gather(0, star[None, :])[0].to(torch.int32)
        s = torch.zeros(rows, dtype=f32)
        for u in range(len(spans)):
            s = s + s_t[u] * torch.exp(m_t[u] - m)
        mass = (m > np.float32(lp_place.NEG * 0.5)).to(f32)
        x_t = [e_t[u] * (torch.exp(m_t[u] - m) * mass / s)[:, None] for u in range(len(spans))]
        if it == iters - 1:
            x_b = [torch.cat([x_t[u] for u, sp in enumerate(spans) if sp[0] == k], dim=1)
                   for k in range(d)]
            break
        # The load in float64 (each float32 product is exact there), rounded
        # to float32 once.
        f64 = torch.float64
        x = torch.cat(x_t, dim=1)
        pad = torch.zeros((rt_n * tr, d * n), dtype=f64)
        pad[:rows] = x.to(f64)
        req = torch.zeros((rt_n * tr, r), dtype=f64)
        req[:rows] = req_aug.to(f64)
        pad, req = pad.view(rt_n, tr, d * n), req.view(rt_n, tr, r)
        partial = torch.zeros((rt_n, d * n, r), dtype=f64)
        for i in range(tr):
            partial = partial + pad[:, i, :, None] * req[:, i, None, :]
        sums = [torch.zeros((d * n, r), dtype=f64) for _ in range(4)]
        for rt in range(rt_n):
            sums[rt % 4] = sums[rt % 4] + partial[rt]
        load = ((sums[0] + sums[1]) + (sums[2] + sums[3])).to(f32)
        cap = torch.cat(cap_b, dim=0)
        ratio = torch.where(load > np.float32(1e-9),
                            cap / torch.clamp(load, min=np.float32(1e-9)),
                            torch.tensor(float("inf"))).min(dim=1).values
        scale = torch.clamp(torch.clamp(ratio, max=1.0), np.float32(1e-6), 1.0)
        upd = torch.log(scale)
        log_v = [log_v[k] + upd[k * n:(k + 1) * n] for k in range(d)]
        gmax.append(float(upd.abs().max()))
    conv = next((j for j, g in enumerate(gmax) if np.float32(g) < np.float32(tol)), -1)
    return x_b, pref, torch.tensor([iters, conv], dtype=torch.int32)


# (seed, rows, n, r_dim, classes, pod_count, static, tight): the tight cases of
# tests/test_torch_lp_place.py, the kernel cases with several row tiles, and
# tight class-weighted rows at 16 capacity columns (r_dim 15 and the pod
# count), where the port's plain version lies 1.19 of the card's limit from
# the kernel's order (tests/test_torch_cuda.py's float64 case).
ORDER_CASES = {
    "tight_64x48": (0, 64, 48, 2, False, True, True, True),
    "tight_classes": (1, 40, 100, 3, True, True, True, True),
    "chunks": smoke.LP_KERNEL_CASES["chunks"][:8],
    "dims9": smoke.LP_KERNEL_CASES["dims9"][:8],
    "cols16_classes": (33, 97, 150, 15, True, True, True, True),
}

ORDER_PLANS = {
    "default": {},
    "rows_tr7": dict(mode="rows", tr=7, batch=3),
    "tiles_32": dict(mode="tiles", tn=32),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("plan_name", sorted(ORDER_PLANS))
@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_kernel_order_matches_jax(case, plan_name, d):
    import jax.numpy as jnp

    from scheduler_tpu.ops import lp_place as jax_lp

    seed, rows, n, r_dim, classes, pod_count, static, tight = ORDER_CASES[case]
    n = -(-n // d) * d
    ops = smoke.lp_operands(seed, rows, n, r_dim, classes=classes, pod_count=pod_count,
                            static=static, tight=tight)
    names = ("idle", "allocatable", "task_count", "pods_limit", "node_gate", "static_mask",
             "static_score", "mins", "init_resreq", "resreq")
    count = ops["class_count"]
    want = jax_lp.lp_relax(*[jnp.asarray(ops[k]) for k in names],
                           None if count is None else jnp.asarray(count), iters=200, tau=0.25,
                           tol=1e-3, **ops["flags"])
    x_w, _, pref_w, raw_w = (np.asarray(a) for a in want)
    logits, cap, req_aug = smoke.lp_iterate_operands(ops, torch.device("cpu"))
    nl = n // d
    logits_b = [logits[:, k * nl:(k + 1) * nl].contiguous() for k in range(d)]
    cap_b = [cap[k * nl:(k + 1) * nl].contiguous() for k in range(d)]
    plan = lp_plan(rows, nl, cap.shape[1], d, H100_SMS, **ORDER_PLANS[plan_name])
    x_b, pref, raw = kernel_order_relax(logits_b, cap_b, req_aug, plan, iters=200, tol=1e-3)
    x = torch.cat(x_b, dim=1).numpy()
    assert x.dtype == np.float32 and x.shape == x_w.shape
    np.testing.assert_allclose(x, x_w, rtol=0, atol=MARGINAL_ATOL)
    assert (pref.numpy() == pref_w).all()
    assert (raw.numpy() == raw_w).all()


def _jax_relax(ops):
    import jax.numpy as jnp

    from scheduler_tpu.ops import lp_place as jax_lp

    names = ("idle", "allocatable", "task_count", "pods_limit", "node_gate", "static_mask",
             "static_score", "mins", "init_resreq", "resreq")
    count = ops["class_count"]
    got = jax_lp.lp_relax(*[jnp.asarray(ops[k]) for k in names],
                          None if count is None else jnp.asarray(count), iters=200, tau=0.25,
                          tol=1e-3, **ops["flags"])
    return tuple(np.asarray(a) for a in got)


def test_class_weighted_16_columns_against_float64_and_jax():
    """Tight class-weighted rows at 16 columns: float32 alone puts every
    version far from the float64 solve (the plain version run on float64
    operands), here about 16.6 of the card's limit, so the kernel's limit
    against its plain version cannot hold there, while JAX's float32
    ``lp_relax`` decides between them.  The kernel's order (every forced
    tiling of the card case) lies within the unchanged limit of JAX's
    marginals (``chip_smoke.lp_marginal_errors``), no farther from float64
    than JAX is plus one limit, with JAX's pref and evidence; the port's
    plain version lies farther from JAX (over 1) yet as far from float64."""
    seed, rows, n, r_dim, classes, pod_count, static, tight = ORDER_CASES["cols16_classes"]
    ops = smoke.lp_operands(seed, rows, n, r_dim, classes=classes, pod_count=pod_count,
                            static=static, tight=tight)
    x_j, _, pref_j, raw_j = _jax_relax(ops)
    x_j = torch.from_numpy(np.array(x_j))
    logits, cap, req_aug = smoke.lp_iterate_operands(ops, torch.device("cpu"))
    x64, pref64, _ = lp_place.lp_iterate_reference(logits.double(), cap.double(),
                                                   req_aug.double(), iters=200, tol=1e-3)
    assert x64.dtype == torch.float64

    def over(a, b):
        return smoke.lp_marginal_errors(a.double(), b.double())["over_tol"]

    jax_off = over(x_j, x64)
    assert jax_off > 1.0
    x_p, pref_p, _ = lp_place.lp_iterate_reference(logits, cap, req_aug, iters=200, tol=1e-3)
    assert over(x_p, x_j) > 1.0 and over(x_p, x64) <= jax_off + 1.0
    assert (pref_p.numpy() == pref_j).all() and (pref64.numpy() == pref_j).all()
    for force in ({}, dict(mode="rows"), dict(mode="tiles", tn=32),
                  dict(mode="tiles", tn=64, tr=40, l_rows=1, e_rows=3)):
        plan = lp_plan(rows, n, cap.shape[1], 1, H100_SMS, **force)
        x_b, pref, raw = kernel_order_relax([logits], [cap], req_aug, plan, iters=200, tol=1e-3)
        assert over(x_b[0], x_j) <= 1.0
        assert over(x_b[0], x64) <= jax_off + 1.0
        assert (pref.numpy() == pref_j).all() and (raw.numpy() == raw_j).all()
