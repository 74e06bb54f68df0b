"""The port's placement-step kernel (K1) and ``fused_allocate`` loop against
the JAX ones, on the CPU.

``scheduler_tpu_torch.ops.step_kernel.placement_step`` on CPU tensors runs
its plain PyTorch version (``placement_step_reference``), the line-by-line
twin of the CUDA kernel; the JAX side runs as its own suite runs it: K1
(``make_placement_step``) in interpret mode, ``fused_allocate`` on the CPU.
Tolerance everywhere: none (bitwise).

1. K1's plain version against the JAX kernel on numpy-seeded operands.
2. The port's loop against the JAX loop on the JAX engine's staged operands
   (``interop.fused_operands_from_numpy``), with the mega kernel switched
   off on the engine as the JAX tests switch it off.
3. A per-job-template cluster with more than 4,096 request signatures,
   where both packages' gates pick the loop by themselves: equal staged
   operands and equal allocate outcomes, keyed by name.
4. The gates: where the JAX engine's loop runs without K1 (the XLA step
   arm), the port's runs the same arm and gives the same codes.
"""

import numpy as np
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import step_operands, template_cluster
from scheduler_tpu.actions.allocate import collect_candidates as jax_candidates
from scheduler_tpu.conf import parse_scheduler_conf as jax_conf
from scheduler_tpu.framework import open_session as jax_open
from scheduler_tpu.ops.fused import FusedAllocator as JaxFused
from scheduler_tpu.ops.fused import fused_allocate as jax_fused_allocate
from scheduler_tpu.ops.pallas_kernels import make_placement_step
from scheduler_tpu_torch.actions import allocate as torch_allocate
from scheduler_tpu_torch.actions.allocate import collect_candidates as torch_candidates
from scheduler_tpu_torch.conf import parse_scheduler_conf as torch_conf
from scheduler_tpu_torch.framework import open_session as torch_open
from scheduler_tpu_torch.interop import fused_operands_from_numpy
from scheduler_tpu_torch.ops import fused as fused_mod
from scheduler_tpu_torch.ops import step_kernel as sk
from scheduler_tpu_torch.ops.fused import FUSED_OPERAND_NAMES, HOST_OPERANDS
from scheduler_tpu_torch.ops.fused import FusedAllocator as TorchFused
from tests.test_torch_allocate import open_session, outcome
from tests.test_torch_megakernel import (
    FLAGSHIP_CONF,
    PREDICATES_CONF,
    SCORE_BOUND_CONF,
    twin_cache,
)

CPU_IDX, MEM_IDX = 0, 1


# -- 1. K1: the plain version against the JAX kernel ---------------------------------

# Weights (least-requested, balanced, binpack).  Where two or more terms are
# on, XLA's CPU backend fuses the JAX kernel's score into one loop and
# contracts a term's multiply with the running sum into a fused multiply-add
# (the port never contracts, as its CUDA build with --fmad=false): those
# cases draw operands whose score terms are exact in float32, where both
# roundings agree.  Every other case draws operands that round.
WEIGHTS = [(0.0, 0.0, 1.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0)]
K1_CASES = []
for i in range(32):
    w, cap, static, pod = WEIGHTS[i % 4], bool(i & 4), bool(i & 8), bool(i & 16)
    K1_CASES.append(pytest.param(dict(weights=w, with_capacity=cap, use_static=static,
                                      enforce_pod_count=pod, r_dim=2 + i % 2,
                                      n=128 if i % 3 else 1024, seed=i),
                                 id=f"w{w}-cap{int(cap)}-static{int(static)}-pods{int(pod)}"))
for i, w in enumerate([(1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]):
    # Each remaining single term on rounding operands, with static rows.
    K1_CASES.append(pytest.param(dict(weights=w, with_capacity=True, use_static=True,
                                      enforce_pod_count=bool(i), r_dim=2 + i, n=1024,
                                      seed=40 + i), id=f"w{w}-cap1-static1-pods{i}"))
for special in ("infeasible", "ties"):
    K1_CASES.append(pytest.param(dict(weights=(1.0, 1.0, 1.0), with_capacity=True,
                                      use_static=True, enforce_pod_count=True, r_dim=2,
                                      n=1024, seed=99, **{special: True}), id=special))


def contracts(weights) -> bool:
    """Whether XLA's CPU backend may contract the JAX kernel's score."""
    return sum(w != 0.0 for w in weights) >= 2


@pytest.mark.parametrize("case", K1_CASES)
def test_reference_matches_jax_placement_step(case):
    case = dict(case)
    n, r_dim, seed = case.pop("n"), case.pop("r_dim"), case.pop("seed")
    infeasible, ties = case.pop("infeasible", False), case.pop("ties", False)
    ops = step_operands(seed, n, r_dim, infeasible=infeasible, ties=ties,
                        exact=contracts(case["weights"]) and not infeasible)
    kw = dict(r_dim=r_dim, r8=8, cpu_idx=CPU_IDX, mem_idx=MEM_IDX, **case)
    jax_step = make_placement_step(r_dim, 8, n, kw["weights"], kw["use_static"],
                                   kw["enforce_pod_count"], CPU_IDX, MEM_IDX, interpret=True,
                                   with_capacity=kw["with_capacity"])
    best, score, cap, pods = (np.asarray(x) for x in jax_step(*ops))
    expected = int(best), float(score), int(cap), int(pods)
    before = sk.launches
    got = tuple(x.item() for x in sk.placement_step(*(torch.from_numpy(a.copy()) for a in ops),
                                                   **kw))
    assert sk.launches == before, "the CPU path launches no kernel"
    assert sk.same_result(got, expected), (got, expected)
    if infeasible:
        assert got[:2] == (0, float("-inf"))
    if ties:
        # Equal scores on every feasible node: the lowest feasible index.
        feasible = np.nonzero(ops[4][0] & ops[2][0] & (ops[0][8] < ops[5][0]))[0]
        assert got[0] == feasible[0] and feasible.size > 1
    if not kw["with_capacity"]:
        assert got[2:] == (0, 0)


def test_placement_step_checks_its_operands():
    ops = [torch.from_numpy(a) for a in step_operands(0, 128, 2)]
    kw = dict(r_dim=2, r8=8, weights=(0.0, 0.0, 1.0), use_static=False,
              enforce_pod_count=False, cpu_idx=CPU_IDX, mem_idx=MEM_IDX, with_capacity=True)
    best, score, cap, pods = sk.placement_step(*ops, **kw)
    assert torch.isfinite(score) and 1 <= int(cap) <= sk.CAP_GRID and int(pods) == sk.CAP_GRID
    with pytest.raises(ValueError, match="gate"):
        sk.placement_step(*ops[:4], ops[4].float(), *ops[5:], **kw)
    with pytest.raises(ValueError, match="initq"):
        sk.placement_step(*ops[:6], ops[6][:4], *ops[7:], **kw)


# -- 2. the loop: the port's against the JAX one ---------------------------------------

def jax_engine(cache, conf):
    ssn = jax_open(cache, jax_conf(conf).tiers)
    return JaxFused(ssn, jax_candidates(ssn))


def port_engine(cache, conf):
    ssn = torch_open(cache, torch_conf(conf).tiers, device="cpu")
    return TorchFused(ssn, torch_candidates(ssn), device="cpu")


def template_twin(pkg, n_nodes=64, n_jobs=120, tasks_per_job=8):
    return template_cluster(n_nodes, n_jobs, tasks_per_job, pkg)


LOOP_CASES = {
    # Gangs of 6 (min_member 3): ready-with-tail jobs re-enter through the
    # comparator chain; single-task jobs batch across jobs.
    "mixed": (lambda pkg: twin_cache(pkg, "mixed"), FLAGSHIP_CONF, {}),
    "mixed-pod-count": (lambda pkg: twin_cache(pkg, "mixed"), FLAGSHIP_CONF,
                        {"enforce_pod_count": True}),
    # Static rows, weights (1, 1, 0), no runs: K1 without capacity.
    "static": (lambda pkg: twin_cache(pkg, "static"), PREDICATES_CONF, {}),
    # Per-job templates, binpack only: runs batch, K1 with capacity.
    "templates-64x120x8": (template_twin, FLAGSHIP_CONF, {}),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_matches_jax_loop(case):
    build, conf, overrides = LOOP_CASES[case]
    engine = jax_engine(build("scheduler_tpu"), conf)
    engine.use_mega = False
    assert engine.step_kernel, "the JAX engine must run its loop with K1"
    kw = dict(engine._allocate_kw(), **overrides)
    expected = np.asarray(jax_fused_allocate(*engine.args, **kw))
    args, port_kw = fused_operands_from_numpy([np.asarray(a) for a in engine.args], kw, "cpu")
    codes, stats = fused_mod.fused_allocate(*args, **port_kw)
    np.testing.assert_array_equal(codes.numpy(), expected)
    assert int((expected >= 0).sum()) > 0 and stats["steps"] > 0
    assert port_kw["use_static"] == (conf is PREDICATES_CONF)
    assert port_kw["batch_runs"] == (case != "static")
    if case.startswith("mixed"):
        assert stats["chain_selects"] > 0, "dirty jobs must go through the comparator chain"
    if overrides:
        return
    # The port's own engine on the same cluster, switched to its loop after
    # it chose the mega kernel: the operands it stages lazily give the codes.
    port = port_engine(build("scheduler_tpu_torch"), conf)
    assert port.engine == "mega" and port.step_kernel
    port.use_mega = False
    assert port.engine == "step"
    np.testing.assert_array_equal(port.readback(), expected)
    assert port.run_stats()["steps"] == stats["steps"]


# -- 3. where both packages pick the loop by their own gates -------------------------

def many_templates(pkg):
    """64 nodes, 4,200 single-pod jobs of distinct requests: more than 4,096
    request signatures close the mega gate."""
    return template_twin(pkg, 64, 4200, 1)


def test_port_picks_the_loop_and_stages_the_jax_operands():
    engine = jax_engine(many_templates("scheduler_tpu"), FLAGSHIP_CONF)
    assert not engine.use_mega and engine.step_kernel
    port = port_engine(many_templates("scheduler_tpu_torch"), FLAGSHIP_CONF)
    assert not port.use_mega and port.step_kernel and port.engine == "step"
    theirs, their_kw = fused_operands_from_numpy([np.asarray(a) for a in engine.args],
                                                 engine._allocate_kw(), "cpu")
    for name, mine, other in zip(FUSED_OPERAND_NAMES, port.args, theirs):
        assert isinstance(mine, np.ndarray) == (name in HOST_OPERANDS), name
        assert type(mine) is type(other) and mine.dtype == other.dtype, name
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(other), err_msg=name)
    assert port._allocate_kw() == their_kw


def test_allocate_on_the_loop_matches_jax():
    outcomes = []
    for pkg in ("scheduler_tpu", "scheduler_tpu_torch"):
        cache = many_templates(pkg)
        ssn = open_session(pkg, cache, FLAGSHIP_CONF)
        routes = dict(torch_allocate.routes)
        __import__(f"{pkg}.framework", fromlist=["get_action"]).get_action(
            "allocate").execute(ssn)
        outcomes.append(outcome(pkg, cache, ssn))
    assert torch_allocate.routes["fused"] == routes["fused"] + 1
    assert torch_allocate.routes["host"] == routes["host"]
    (jax_statuses, jax_errors, jax_binds), (statuses, errors, binds) = outcomes
    assert binds == jax_binds
    assert statuses == jax_statuses
    assert errors == jax_errors
    assert binds and errors, "the 64 nodes hold some of the 4,200 pods, not all"


# -- 4. the gates ----------------------------------------------------------------------

def test_xla_step_arm_raises_in_the_port():
    """Runs plus nodeorder's weights turn the top-2 score bound on, so the
    JAX engine takes its loop WITHOUT K1 where the mega gate closes.  The
    port took to raising here before it had the XLA step arm; now its engine
    picks that arm by the same gate and gives the JAX loop's codes, and its
    loop keeps the arm when asked for K1 (the gate holds inside it)."""
    engine = jax_engine(template_twin("scheduler_tpu", 64, 4200, 2), SCORE_BOUND_CONF)
    assert not engine.use_mega and not engine.step_kernel and engine.batch_runs
    expected = np.asarray(jax_fused_allocate(*engine.args, **engine._allocate_kw()))
    port = port_engine(template_twin("scheduler_tpu_torch", 64, 4200, 2), SCORE_BOUND_CONF)
    assert port.engine == "xla" and not port.step_kernel
    np.testing.assert_array_equal(port.readback(), expected)
    args, kw = fused_operands_from_numpy(
        [np.asarray(a) for a in engine.args], dict(engine._allocate_kw(), step_kernel=True),
        "cpu")
    codes, stats = fused_mod.fused_allocate(*args, **kw)
    assert stats["arm"] == "xla"
    np.testing.assert_array_equal(codes.numpy(), expected)


def test_mega_sessions_keep_the_mega_kernel():
    for build, conf in ((lambda pkg: twin_cache(pkg, "mixed"), FLAGSHIP_CONF),
                        (template_twin, FLAGSHIP_CONF),
                        (lambda pkg: twin_cache(pkg, "spill"), SCORE_BOUND_CONF)):
        engine = jax_engine(build("scheduler_tpu"), conf)
        port = port_engine(build("scheduler_tpu_torch"), conf)
        assert engine.use_mega and port.engine == "mega"
        assert port.step_kernel == engine.step_kernel
