"""The loop's XLA step arm in the port against the JAX arm, on the CPU.

``ops/xla_step.py::xla_step_reference`` is the plain version of the
``xla_step`` CUDA kernel (``csrc/xla_step.cu``).  Here it is held to the
JAX loop's XLA step arm (``scheduler_tpu/ops/fused.py:704-864``), composed
below from the JAX package's own ``dynamic_score`` in the arm's order, on
the same operands made with numpy: the five results and the node state
after each step, bitwise (tolerance: none), over several steps of random
operands with releasing capacity or not, the score bound or not, static
rows and the pod count, host caps of 1, 2 and 128, and 40 and 100
resource dims.  Also: the kernel's
launch plan (its choices and its errors), the planted operands the card's
tests use (each checked with the plain version to have the property it
claims, and held to the JAX arm), and that CPU tensors take the plain
version and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from scheduler_tpu.ops.scoring import dynamic_score as jax_dynamic_score
from scheduler_tpu_torch.ops import xla_step

MAX_BATCH = 128


def jax_arm_step(ops, t, s, hi0, *, weights, use_static, enforce_pod_count, has_releasing,
                 batch_runs, score_bound):
    """One step of the JAX loop's XLA step arm (``fused.py:704-864``, the
    branch without the step kernel) on numpy operands: ``(best, feasible,
    alloc, pipe, m)`` and the node state after the winner's row add."""
    ns = jnp.asarray(ops["node_state"])
    allocatable = jnp.asarray(ops["allocatable"])
    pods_limit = jnp.asarray(ops["pods_limit"])
    node_gate = jnp.asarray(ops["node_gate"])
    mins = jnp.asarray(ops["mins"])
    static_mask = jnp.asarray(ops["static_mask"])
    static_score = jnp.asarray(ops["static_score"])
    n, r_dim = allocatable.shape
    init_req = jnp.asarray(ops["init_resreq"])[t]
    req = jnp.asarray(ops["resreq"])[t]
    idle = ns[:, :r_dim]
    neg_inf = jnp.float32(-jnp.inf)
    pods_limit_f = pods_limit.astype(jnp.float32)
    if has_releasing:
        avail2 = ns[:, : 2 * r_dim].reshape(-1, 2, r_dim)
        ok2 = jnp.all((init_req[None, None, :] < avail2)
                      | (jnp.abs(avail2 - init_req[None, None, :]) < mins[None, None, :]),
                      axis=-1)
        fit_idle, fit_rel = ok2[:, 0], ok2[:, 1]
        feasible = (fit_idle | fit_rel) & node_gate
    else:
        fit_idle = jnp.all((init_req[None, :] < idle)
                           | (jnp.abs(idle - init_req[None, :]) < mins[None, :]), axis=-1)
        feasible = fit_idle & node_gate
    if use_static:
        feasible = feasible & static_mask[s]
    if enforce_pod_count:
        feasible = feasible & (ns[:, 2 * r_dim] < pods_limit_f)
    score = jax_dynamic_score(req, idle, allocatable, *weights)
    if use_static:
        score = score + static_score[s]
    masked = jnp.where(feasible, score, neg_inf)
    best = jnp.argmax(masked)
    any_feasible = masked[best] > neg_inf
    if has_releasing:
        alloc_here = any_feasible & fit_idle[best]
        pipe_here = any_feasible & ~fit_idle[best] & fit_rel[best]
    else:
        alloc_here = any_feasible
        pipe_here = jnp.asarray(False)
    if batch_runs:
        hi = jnp.int32(hi0)
        if enforce_pod_count:
            hi = jnp.minimum(hi, pods_limit[best] - ns[best, 2 * r_dim].astype(jnp.int32))
        hi = jnp.maximum(hi, 1)
        idle_b = idle[best]
        js = jnp.arange(1, MAX_BATCH + 1, dtype=jnp.int32)
        avail = idle_b[None, :] - (js - 1).astype(idle_b.dtype)[:, None] * req[None, :]
        ok_js = jnp.all((init_req[None, :] < avail)
                        | (jnp.abs(avail - init_req[None, :]) < mins[None, :]), axis=-1)
        if score_bound:
            others = jnp.where(jnp.arange(n) == best, neg_inf, masked)
            second = jnp.max(others)
            second_idx = jnp.argmax(others)
            alloc_b = jnp.broadcast_to(allocatable[best][None, :], (MAX_BATCH, r_dim))
            s_js = jax_dynamic_score(req, avail, alloc_b, *weights)
            if use_static:
                s_js = s_js + static_score[s, best]
            ok_s = (s_js > second) | ((s_js == second) & (best < second_idx))
            ok_js = ok_js & (jnp.cumprod(ok_s.astype(jnp.int32)) > 0)
        fit_count = jnp.max(jnp.where(ok_js & (js <= hi), js, 1))
        m = jnp.where(alloc_here, fit_count, 1)
    else:
        m = jnp.int32(1)
    m_f = m.astype(ns.dtype)
    copies = jnp.where(alloc_here, m, 1)
    node_row = jnp.concatenate([
        -req * (alloc_here * m_f),
        -req * pipe_here,
        (((alloc_here | pipe_here) * copies).astype(ns.dtype))[None],
    ])
    ns = ns.at[best].add(node_row)
    result = (int(best), bool(any_feasible), bool(alloc_here), bool(pipe_here), int(m))
    return result, np.asarray(ns)


def port_step(ops, t, s, hi0, **flags):
    """The port's plain version on CPU tensors of the same numpy operands."""
    tens = {k: torch.from_numpy(np.array(v)) for k, v in ops.items()}
    result = xla_step.xla_step_reference(
        tens["node_state"], tens["allocatable"], tens["pods_limit"], tens["node_gate"],
        tens["mins"], tens["init_resreq"], tens["resreq"], tens["static_mask"],
        tens["static_score"], t, s, hi0, **flags)
    return result, tens["node_state"].numpy()


def assert_same_steps(ops, steps, **flags):
    """``steps`` (task row, static row, host cap) in turn through both arms,
    each from the state the last step left: equal results and node state,
    bit for bit."""
    ops = {k: np.array(v) for k, v in ops.items()}
    seen = []
    for t, s, hi0 in steps:
        want, ns_want = jax_arm_step(ops, t, s, hi0, **flags)
        got, ns_got = port_step(ops, t, s, hi0, **flags)
        assert got == want, (t, s, hi0)
        np.testing.assert_array_equal(ns_got.view(np.int32), ns_want.view(np.int32))
        ops["node_state"] = ns_got
        seen.append(got)
    return seen


@pytest.mark.parametrize("hi0", [1, 2, 128])
@pytest.mark.parametrize("score_bound", [True, False])
@pytest.mark.parametrize("releasing", [True, False])
def test_reference_matches_jax_arm(releasing, score_bound, hi0):
    ops = smoke.xla_step_operands(11 + hi0, 300, 3, releasing=releasing)
    # Small requests and none of the scalar: the winner has room for more
    # than one copy.
    ops["resreq"][:, :2] = ops["init_resreq"][:, :2] = np.floor(ops["resreq"][:, :2] / 16)
    ops["resreq"][:, 2] = ops["init_resreq"][:, 2] = 0.0
    flags = dict(weights=(1.0, 1.0, 0.0) if score_bound else (0.0, 0.0, 1.0), use_static=True,
                 enforce_pod_count=True, has_releasing=releasing, batch_runs=True,
                 score_bound=score_bound)
    steps = [(t % 4, t % 3, hi0) for t in range(8)]
    seen = assert_same_steps(ops, steps, **flags)
    assert any(ok for _, ok, _, _, _ in seen)
    if hi0 > 1 and score_bound:
        # (Binpack alone picks nearly full nodes here; the planted grid
        # case batches under it.)
        assert max(m for *_, m in seen) > 1
    if releasing:
        assert any(p for _, _, _, p, _ in seen) or any(a for _, _, a, _, _ in seen)


@pytest.mark.parametrize("weights", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (2.0, 1.0, 1.0),
                                     (0.0, 0.0, 0.0)])
def test_reference_matches_jax_arm_bare(weights):
    """No static rows, no pod count, no batching: the fit, each scorer alone
    and all three (the JAX order adds binpack last), and no scorer."""
    ops = smoke.xla_step_operands(5, 257, 2, releasing=False)
    flags = dict(weights=weights, use_static=False, enforce_pod_count=False,
                 has_releasing=False, batch_runs=False, score_bound=False)
    seen = assert_same_steps(ops, [(t % 4, 0, 1) for t in range(6)], **flags)
    assert all(m == 1 for *_, m in seen)


def test_reference_matches_jax_arm_many_steps_until_full():
    """Placements pile onto a small cluster until nothing fits: pipelines
    onto releasing, then infeasible steps (best 0, nothing placed)."""
    ops = smoke.xla_step_operands(3, 40, 2, releasing=True)
    ops["resreq"][:] = ops["init_resreq"][:] = [9000.0, 30000.0]
    flags = dict(smoke.XLA_STEP_FLAGS)
    seen = assert_same_steps(ops, [(0, 0, 128)] * 30, **flags)
    assert any(p for _, _, _, p, _ in seen) and not seen[-1][1] and seen[-1][0] == 0


@pytest.mark.parametrize("kind", sorted(smoke.XLA_STEP_PLANTS))
def test_planted_operands_have_their_property(kind):
    """Each planted case, at every plan the card's tests force, has the
    property its name claims (checked with the plain version), and the plain
    version equals the JAX arm on it."""
    n = smoke.XLA_STEP_PLANTS[kind][0]
    for threads in (None, 128, 512, 1024):
        plan = None if threads is None else xla_step.step_plan(n, threads)
        ops, flags, hi0, roles = smoke.xla_plant_case(kind, plan)
        assert smoke.xla_plant_failures(kind, ops, flags, hi0, roles) == []
        if threads in (None, 128):
            assert_same_steps(ops, [(0, 0, hi0)], **flags)


def test_planted_operands_need_two_strides():
    """A plant needs its nodes in two strides of the plan: fewer nodes are
    refused rather than planted on top of each other."""
    ops = smoke.xla_step_operands(0, 1500, 2)
    with pytest.raises(ValueError):
        smoke.plant_xla_step(ops, "ties_across_strides", 1024)


@pytest.mark.parametrize("r_dim", [40, 100])
def test_reference_matches_jax_arm_many_dims(r_dim):
    """More resource dims than a warp's lanes, and a node row wider than the
    kernel's smallest CTA: the kernel reads the task rows from device
    memory and strides over the dims, and its plain version is held to the
    JAX arm on such operands."""
    ops = smoke.xla_step_operands(r_dim, 200, r_dim, releasing=True)
    ops["resreq"][:, :2] = ops["init_resreq"][:, :2] = np.floor(ops["resreq"][:, :2] / 16)
    # One scalar asked for on the first and the last dim: some nodes fit.
    ops["resreq"][:, 2:] = ops["init_resreq"][:, 2:] = 0.0
    ops["resreq"][:, [2, -1]] = ops["init_resreq"][:, [2, -1]] = 1.0
    steps = [(t % 4, t % 3, (1, 2, 128)[t % 3]) for t in range(6)]
    seen = assert_same_steps(ops, steps, **smoke.XLA_STEP_FLAGS)
    assert any(ok for _, ok, _, _, _ in seen)


@pytest.mark.parametrize("n,want", [
    (1, (128, 1)), (1000, (1024, 1)), (1024, (1024, 1)),
    (1025, (1024, 2)), (16_384, (1024, 16)), (70_000, (1024, 69)),
])
def test_step_plan_choices(n, want):
    plan = xla_step.step_plan(n)
    assert (plan.threads, plan.strides) == want
    assert plan.threads * plan.strides >= n > plan.threads * (plan.strides - 1)


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 16_384, 70_000])
def test_step_plan_forced_and_refused(n):
    for threads in (128, 256, 512, 1024):
        plan = xla_step.step_plan(n, threads)
        assert plan.threads == threads and plan.strides == -(-n // threads)
    for bad in (96, 2048, 200, 0):
        with pytest.raises(ValueError):
            xla_step.step_plan(n, bad)


def test_step_plan_refuses_no_nodes():
    with pytest.raises(ValueError):
        xla_step.step_plan(0)


def test_cpu_arm_takes_the_plain_version_and_launches_nothing():
    """An arm on CPU tensors runs ``xla_step_reference`` (asking for a plan
    changes nothing there): no launch, no events, the node state on the
    CPU, each step equal to the plain version on a copy."""
    ops = smoke.xla_step_operands(7, 500, 2)
    t = {k: torch.from_numpy(np.array(v)) for k, v in ops.items()}
    r_dim = 2
    ns = ops["node_state"]
    before = xla_step.launches
    arm = xla_step.XlaStep(ns[:, :r_dim], ns[:, r_dim:2 * r_dim], ns[:, -1], t["allocatable"],
                           t["pods_limit"], t["node_gate"], t["mins"], t["init_resreq"],
                           t["resreq"], t["static_mask"], t["static_score"], check_every=1,
                           plan=xla_step.step_plan(500, 256), **smoke.XLA_STEP_FLAGS)
    copy = t["node_state"].clone()
    for k in range(5):
        got = arm.step(k % 4, k % 3, 128)
        want = xla_step.xla_step_reference(
            copy, t["allocatable"], t["pods_limit"], t["node_gate"], t["mins"],
            t["init_resreq"], t["resreq"], t["static_mask"], t["static_score"], k % 4, k % 3,
            128, **smoke.XLA_STEP_FLAGS)
        assert got == want
    arm.close()
    assert torch.equal(arm.node_state.view(torch.int32), copy.view(torch.int32))
    assert xla_step.launches == before
    assert arm.node_state.device.type == "cpu" and arm.plan is None
    assert arm.xla_ms is None and arm.host_ms is None and arm.checked == 0 and arm.steps == 5
