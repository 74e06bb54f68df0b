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
session tensors, against the JAX scan on the gathered rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import scan_operands
from scheduler_tpu.ops import placement as jp
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
