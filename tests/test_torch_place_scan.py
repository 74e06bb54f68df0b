"""The port's placement scan against the JAX package's, on the CPU.

``scheduler_tpu_torch/ops/placement.py::_place_scan`` (the plain PyTorch
version of ``csrc/place_scan.cu`` on CPU tensors) against
``scheduler_tpu/ops/placement.py::_place_scan`` (a ``lax.scan`` under
``jax.jit``) on the same operands (``chip_smoke.scan_operands``, drawn with
numpy from a seed): chosen nodes, pipelined and failed flags and the
returned node state (idle, releasing, task counts) must be bitwise equal.
Cases: the weights (none, each term alone, two and three terms), ready
deficits <= 0, 1 and the pop's length, the pod-count gate on and off,
releasing capacity (pipelines), padding rows, no static score rows, an
infeasible first task, more resource dims.  Where two or more score terms
meet the operands are exact in float32 (``exact``): XLA's CPU backend
contracts a product into the sum that follows it, the port never does.
Also ``sequential_place_job`` reading the pop's rows by index from the
session tensors, against the JAX scan on the gathered rows; the CUDA
kernel's tie and boundary operands (``chip_smoke.plant_scan``: equal
scores in different CTAs' node slices, winners on a slice's first and last
node, consecutive winners in rank 0 and in the last rank), a node count
past a slice cut and a ready break mid-pop at cluster scale; and the launch
plan (``scan_plan``): its slices cover ``[0, n_active)`` exactly once,
contiguous, and its arm fits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import plant_scan, scan_operands
from scheduler_tpu.ops import placement as jp
from scheduler_tpu_torch.ops import place_scan_kernel as psk
from scheduler_tpu_torch.ops import placement as tp

WEIGHTS = {
    "none": (0.0, 0.0, 0.0),
    "least": (1.0, 0.0, 0.0),
    "balanced": (0.0, 1.0, 0.0),
    "binpack": (0.0, 0.0, 1.0),
    "nodeorder": (1.0, 1.0, 0.0),
    "all": (2.0, 1.0, 0.5),
}


def _gathered(ops):
    """The pop's task rows in scan order (the JAX layout)."""
    rows = ops["rows"]
    score = ops["static_score"]
    return (ops["init_resreq"][rows], ops["resreq"][rows], ops["static_mask"][rows],
            None if score is None else score[rows])


def _jax_scan(ops, valid, deficit, weights, enforce):
    init, req, mask, score = _gathered(ops)
    if score is None:
        score = np.zeros(mask.shape, np.float32)
    out = jp._place_scan(
        jnp.asarray(ops["idle"]), jnp.asarray(ops["releasing"]), jnp.asarray(ops["task_count"]),
        jnp.asarray(ops["allocatable"]), jnp.asarray(ops["pods_limit"]),
        jnp.asarray(ops["mins"]), jnp.asarray(init), jnp.asarray(req), jnp.asarray(mask),
        jnp.asarray(score), jnp.asarray(valid), jnp.asarray(deficit, dtype=jnp.int32),
        weights, enforce)
    return [np.asarray(x) for x in out]


def _port_scan(ops, valid, deficit, weights, enforce):
    init, req, mask, score = _gathered(ops)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    out = tp._place_scan(t(ops["idle"]), t(ops["releasing"]), t(ops["task_count"]),
                         t(ops["allocatable"]), t(ops["pods_limit"]), t(ops["mins"]), t(init),
                         t(req), t(mask), t(score), t(valid), deficit, weights, enforce)
    return [x.numpy() for x in out]


def _assert_bitwise(port, ref):
    names = ("idle", "releasing", "task_count", "chosen", "pipelined", "failed")
    for name, a, b in zip(names, port, ref):
        assert a.dtype.kind == b.dtype.kind, name
        assert np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                              b.view(np.int32) if b.dtype == np.float32 else b), name


def _exact(weights, score):
    return sum(w != 0.0 for w in weights) + bool(score) >= 2


@pytest.mark.parametrize("wname", sorted(WEIGHTS))
@pytest.mark.parametrize("score", [True, False])
@pytest.mark.parametrize("enforce", [True, False])
def test_scan_matches_jax_by_weights(wname, score, enforce):
    weights = WEIGHTS[wname]
    t = 24
    ops = scan_operands(3, 97, t, exact=_exact(weights, score), score=score)
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, weights, enforce)
    port = _port_scan(ops, valid, t, weights, enforce)
    _assert_bitwise(port, ref)
    assert (ref[3] >= 0).sum() > 4


@pytest.mark.parametrize("deficit", [-2, 0, 1, 5, 16])
@pytest.mark.parametrize("seed", [0, 11])
def test_scan_matches_jax_by_ready_deficit(deficit, seed):
    t = 16
    weights = WEIGHTS["nodeorder"]
    ops = scan_operands(seed, 40, t, exact=True)
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, deficit, weights, True)
    _assert_bitwise(_port_scan(ops, valid, deficit, weights, True), ref)
    placed = ref[3] >= 0
    if deficit <= 0:
        assert placed.sum() == 1  # the first placement of any kind stops the pop
    elif deficit < t:
        # The pop stops at the placement that makes the deficit-th allocation.
        allocated = placed & ~ref[4]
        last = int(np.nonzero(placed)[0][-1])
        assert allocated.sum() == deficit and allocated[last]


def test_scan_pipelines_onto_releasing_capacity():
    """Idle runs out within the pop: later tasks pipeline, and the
    pipelines never count toward the ready deficit."""
    t = 32
    ops = scan_operands(5, 12, t, exact=True)
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, WEIGHTS["binpack"], False)
    _assert_bitwise(_port_scan(ops, valid, t, WEIGHTS["binpack"], False), ref)
    assert ref[4].any() and (~ref[4] & (ref[3] >= 0)).any()


@pytest.mark.parametrize("where", ["first", "later"])
def test_scan_stops_at_the_first_infeasible_task(where):
    t = 12
    ops = scan_operands(9, 30, t, exact=True, infeasible=True)
    # The infeasible request (row 0) lands at the pop's first or fourth task.
    first = 0 if where == "first" else 3
    rows = ops["rows"]
    k = int(np.nonzero(rows == 0)[0][0])
    rows[[k, first]] = rows[[first, k]]
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, WEIGHTS["least"], True)
    _assert_bitwise(_port_scan(ops, valid, t, WEIGHTS["least"], True), ref)
    assert ref[5][first] and ref[5].sum() == 1 and (ref[3][first:] == -1).all()


def test_scan_all_infeasible_masks():
    t = 8
    ops = scan_operands(4, 50, t)
    ops["static_mask"][:] = False
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, WEIGHTS["binpack"], False)
    _assert_bitwise(_port_scan(ops, valid, t, WEIGHTS["binpack"], False), ref)
    assert ref[5][0] and (ref[3] == -1).all()


def test_scan_skips_padding_rows():
    """Pad rows (valid False) place nothing and stop nothing."""
    t = 16
    ops = scan_operands(21, 33, t, exact=True)
    valid = np.ones(t, bool)
    valid[5] = valid[9] = False
    valid[12:] = False
    ref = _jax_scan(ops, valid, t, WEIGHTS["nodeorder"], True)
    _assert_bitwise(_port_scan(ops, valid, t, WEIGHTS["nodeorder"], True), ref)
    assert ref[3][5] == -1 and ref[3][9] == -1 and (ref[3][12:] == -1).all()


@pytest.mark.parametrize("r_dim", [3, 5])
def test_scan_matches_jax_with_scalar_dims(r_dim):
    t = 16
    ops = scan_operands(7, 64, t, r_dim=r_dim, exact=True)
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, WEIGHTS["all"], True)
    _assert_bitwise(_port_scan(ops, valid, t, WEIGHTS["all"], True), ref)


@pytest.mark.parametrize("score", [True, False])
def test_sequential_place_job_reads_rows_by_index(score):
    """The engine's call: the pop's rows by index from the session tensors
    (pad node columns past ``n_active`` masked off), node state updated in
    place, against the JAX scan on the gathered rows."""
    n, t, n_rows = 40, 10, 30
    ops = scan_operands(13, n, t, exact=True, score=score, n_rows=n_rows)
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, WEIGHTS["nodeorder"], True)

    pad = 24  # pad node columns: infeasible even where their mask says yes

    def padded(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    state = tp.NodeState(
        idle=torch.from_numpy(padded(ops["idle"], 1e6)),
        releasing=torch.from_numpy(padded(ops["releasing"], 1e6)),
        task_count=torch.from_numpy(padded(ops["task_count"], 0)),
        allocatable=torch.from_numpy(padded(ops["allocatable"], 1e6)),
        pods_limit=torch.from_numpy(padded(ops["pods_limit"], 100)),
        mins=torch.from_numpy(ops["mins"]))
    mask = np.concatenate([ops["static_mask"], np.ones((n_rows, pad), bool)], axis=1)
    score_t = None
    if score:
        score_t = torch.from_numpy(np.concatenate(
            [ops["static_score"], np.full((n_rows, pad), 1e6, np.float32)], axis=1))
    spec = tp.JobPlacementSpec(
        init_resreq=torch.from_numpy(ops["init_resreq"]), resreq=torch.from_numpy(ops["resreq"]),
        static_mask=torch.from_numpy(mask), static_score=score_t,
        rows=torch.from_numpy(ops["rows"]), ready_deficit=t, n_active=n)
    state, result = tp.sequential_place_job(state, spec, WEIGHTS["nodeorder"], True)
    port = [state.idle.numpy()[:n], state.releasing.numpy()[:n], state.task_count.numpy()[:n],
            result.chosen, result.pipelined, result.failed]
    _assert_bitwise(port, ref)


@pytest.mark.parametrize("kind", ["ties", "edges", "ranks"])
@pytest.mark.parametrize("ctas", [8, 16])
def test_scan_matches_jax_on_planted_slices(kind, ctas):
    """The kernel's slice boundaries at 10,000 nodes: the planted nodes win
    first, in index order, each as often as its pod room allows."""
    t, n = 40, 10_000
    ops = scan_operands(17, n, t)
    plan = psk.scan_plan(n, 2, t, WEIGHTS["none"], True, ctas)
    nodes = plant_scan(ops, kind, psk.node_slices(n, plan))
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, t, WEIGHTS["none"], True)
    _assert_bitwise(_port_scan(ops, valid, t, WEIGHTS["none"], True), ref)
    expect = np.repeat(nodes, 2 if kind == "ties" else 1)[:t]
    assert np.array_equal(ref[3][:len(expect)], expect)


@pytest.mark.parametrize("n,t,deficit", [(10_001, 50, 50), (3000, 60, 7)])
def test_scan_matches_jax_at_cluster_scale(n, t, deficit):
    """A node count one past a cut of 16 slices, and a ready break in the
    middle of a pop."""
    ops = scan_operands(22, n, t, exact=True)
    valid = np.ones(t, bool)
    ref = _jax_scan(ops, valid, deficit, WEIGHTS["nodeorder"], True)
    _assert_bitwise(_port_scan(ops, valid, deficit, WEIGHTS["nodeorder"], True), ref)
    placed = ref[3] >= 0
    assert placed.sum() >= min(deficit, t) and (placed & ~ref[4]).sum() <= deficit


PLAN_SHAPES = [(0, 1), (1, 6), (7, 12), (1000, 1), (1024, 100), (1025, 100), (10_000, 100),
               (10_001, 100), (65_536, 100), (131_072, 100)]


@pytest.mark.parametrize("n_active,t", PLAN_SHAPES)
@pytest.mark.parametrize("r", [2, 32])
def test_scan_plan_slices_cover_the_nodes(n_active, t, r):
    """Every plan, the wrapper's and the forced ones: the CTAs' slices are
    contiguous and cover [0, n_active) once; an on-chip slice fits."""
    for ctas in (None, 1, 2, 4, 8, 16):
        for arm in (None, "global"):
            plan = psk.scan_plan(n_active, r, t, (1.0, 1.0, 0.0), True, ctas, arm)
            slices = psk.node_slices(n_active, plan)
            assert len(slices) == plan.ctas
            assert plan.threads == (psk.THREADS_R2 if r == 2 else psk.THREADS)
            at = 0
            for base, count in slices:
                assert base == at and 0 <= count <= plan.slice
                at = base + count
            assert at == n_active and plan.slice % 4 == 0
            assert plan.ctas * plan.slice >= n_active
            if plan.on_chip:
                assert plan.smem_bytes == plan.slice * psk.slice_words(r, True, True) * 4
                assert plan.smem_bytes <= psk.SMEM_LIMIT - psk.STATIC_SMEM and t > 1
            else:
                assert plan.smem_bytes == 0


def test_scan_plan_defaults_and_refusals():
    """The production conf's pop (10,000 nodes, 100 tasks): 16 CTAs, the
    slice on chip; a one-task pop at 1,000 nodes (config 2): one CTA, the
    global arm; a slice past shared memory: the global arm, and refused
    when the shared arm is forced; a cluster size the card cannot take."""
    plan = psk.scan_plan(10_000, 2, 100, (1.0, 1.0, 0.0), True)
    assert (plan.ctas, plan.slice, plan.on_chip) == (16, 628, True)
    assert plan.describe()["arm"] == "shared"
    plan = psk.scan_plan(1000, 2, 1, (1.0, 1.0, 0.0), True)
    assert (plan.ctas, plan.on_chip) == (1, False)
    assert psk.scan_plan(1000, 2, 5, (0.0, 0.0, 0.0), False).on_chip
    assert not psk.scan_plan(200_000, 2, 100, (1.0, 1.0, 0.0), True).on_chip
    with pytest.raises(ValueError):
        psk.scan_plan(10_000, 32, 100, (1.0, 1.0, 0.0), True, 8, "shared")
    with pytest.raises(ValueError):
        psk.scan_plan(10_000, 2, 100, (1.0, 1.0, 0.0), True, 3)
    with pytest.raises(ValueError):
        psk.scan_plan(10_000, 2, 100, (1.0, 1.0, 0.0), True, None, "texture")
