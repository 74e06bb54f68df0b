"""The ``fused_allocate`` loop's three arms in the port against the JAX loop,
on the CPU.

The JAX loop (``scheduler_tpu/ops/fused.py:175-1030``) has, besides the
cursor with the placement-step kernel (K1), the XLA step arm (no K1: the
top-2 score bound, releasing capacity, or a node bucket past the kernel's
budget), the queue pop of multi-queue and unsorted sessions (delta,
full-recompute and ladder chains) and the releasing arm (the joint idle /
releasing fit, pipelined codes ``-3 - node``).  Tolerance everywhere: none
(codes bitwise; statuses, FitErrors, ledgers, queue attributes and stats
equal).

1. The port's loop against the JAX loop on the JAX engine's staged operands
   (``interop.fused_operands_from_numpy``), the mega kernel switched off on
   the engine as the JAX tests switch it off, and ``step_kernel=False``
   where the XLA arm is asked for: binpack-only and score-bound runs
   (nodes of power-of-two capacities: every score term is exact in
   float32, where XLA's CPU backend contracts a product into a sum), static
   rows by signature, the pod count, cross-job batching; the multi-queue
   pop on the delta, full-recompute and ladder chains and the 1:9
   starvation session, each with K1's plain version and with the XLA arm;
   the releasing arm on ``tests/test_fused.py``'s ``build_releasing_cluster``
   seeds and config 4's aftermath at 2 % with 1,000 distinct ``thin``
   requests.  The port's own engine on the twin cluster, switched to its
   loop, stages operands that give the same codes.
2. The XLA arm keeps its node state on the engine's device.

``tests/test_torch_loop_paths.py`` holds the sessions where both packages'
gates pick the loop by themselves to the JAX package end to end.

The JAX side runs proportion's default device water-fill, which needs
``jax.experimental.enable_x64``: this jax lacks it, and each test here
substitutes ``jax.enable_x64`` (an autouse fixture of this module only).
"""


import jax
import jax.experimental
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from scheduler_tpu.ops.fused import fused_allocate as jax_fused_allocate
from scheduler_tpu_torch.interop import fused_operands_from_numpy
from scheduler_tpu_torch.ops import fused as fused_mod
from scheduler_tpu_torch.ops import step_kernel as sk
from scheduler_tpu_torch.ops.xla_step import XlaStep
from tests.test_torch_ladder import ladder_twin
from tests.test_torch_megakernel import (
    CONFIG2_CONF,
    FLAGSHIP_CONF,
    PREDICATES_CONF,
    SCORE_BOUND_CONF,
    build_twin,
    kubemark_twin,
    twin_cache,
)
from tests.test_torch_releasing import (
    PROPORTION_CONF,
    _modules,
    open_in,
    releasing_twin,
)

GIB = 2.0**30


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


# -- twins ---------------------------------------------------------------------------

def templates(pkg, n_nodes, n_jobs, tasks, queues=None):
    """``chip_smoke.template_cluster`` in either package on nodes of 65,536 m
    cpu and 256 GiB (powers of two in the device units, so nodeorder's terms
    are exact); ``queues`` deals the gangs to q0, q1, q2 of weights 1:2:3."""
    kw = dict(node_cpu_milli=65536.0, node_memory=256.0 * GIB)
    if queues:
        kw.update(queues=smoke.MQ_QUEUES, queue_weights=smoke.MQ_WEIGHTS)
    return smoke.template_cluster(n_nodes, n_jobs, tasks, pkg, **kw)


def aftermath(pkg, scale, thin_requests):
    """``harness.make_reclaim_aftermath_cluster(scale, thin_requests)`` in
    either package: the port's harness, and the same recipe with the JAX
    package's objects (``tests/test_torch_releasing.py::aftermath_twin``)
    with the ``thin`` pods' requests of ``harness.aftermath_thin_requests``."""
    from scheduler_tpu_torch.harness import aftermath_thin_requests, make_reclaim_aftermath_cluster

    if pkg == "scheduler_tpu_torch":
        return make_reclaim_aftermath_cluster(scale, thin_requests=thin_requests).cache
    objects, vocab, cache_mod = _modules(pkg)
    gang, n_nodes, n_run, n_pend = 50, int(1000 * scale), int(25_000 * scale), int(50_000 * scale)
    slots = n_run // n_nodes + 1
    thin = aftermath_thin_requests(n_pend, thin_requests)
    ts0 = 1_700_000_000.0
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    for k, name in enumerate(("fat", "thin")):
        queue = objects.Queue(name=name, weight=1)
        queue.creation_timestamp = ts0 + k * 1e-6
        cache.add_queue(queue)
    for i in range(n_nodes):
        cache.add_node(objects.NodeSpec(name=f"n{i:05d}", allocatable={
            "cpu": 2000.0 * slots, "memory": 4 * GIB * slots, "pods": 110}))

    def add_gang(name, queue, ts, running, first):
        pg = objects.PodGroup(name=name, namespace="d", queue=queue, min_member=1)
        pg.status.phase = "Running" if running else "Inqueue"
        pg.creation_timestamp = ts
        cache.add_pod_group(pg)
        for t in range(gang):
            req = {"cpu": 2000.0, "memory": 4 * GIB} if running else thin[first + t]
            pod = objects.PodSpec(
                name=f"{name}-{t}", namespace="d", containers=[dict(req)],
                annotations={objects.GROUP_NAME_ANNOTATION: name},
                node_name=f"n{(first + t) % n_nodes:05d}" if running else "",
                phase="Running" if running else "Pending")
            pod.creation_timestamp = ts + t * 1e-6
            cache.add_pod(pod)

    n_fat = n_run // gang
    for j in range(n_fat):
        add_gang(f"fat{j}", "fat", ts0 + 1.0 + j, True, j * gang)
    for j in range(n_pend // gang):
        add_gang(f"thin{j}", "thin", ts0 + 1.0 + n_fat + j, False, j * gang)
    for j in range(1, n_fat, 2):
        for task in list(cache.jobs[f"d/fat{j}"].tasks.values()):
            cache.evict(task, "reclaim")
    return cache


releasing_templates = smoke.releasing_templates_cluster


# -- 1. the loop against the JAX loop ------------------------------------------------

# case id -> (cluster builder(pkg), conf, JAX loop kwargs overrides).  The
# JAX loop runs once on the arm its gates choose; where that is K1, the
# port's loop runs on K1's plain version and on the XLA arm (the JAX
# package holds its two arms to the same codes), else on the XLA arm.
LOOP_CASES = {
    # Runs under binpack alone (K1 or the XLA arm), and under nodeorder's
    # weights: the top-2 score bound, the XLA arm only.
    "binpack-runs": (lambda pkg: templates(pkg, 16, 60, 6), FLAGSHIP_CONF, {}),
    "score-bound": (lambda pkg: templates(pkg, 16, 60, 6), SCORE_BOUND_CONF, {}),
    # Gangs of 6 (minMember 3) with dirty jobs re-entering the chain, and
    # single-task jobs batching across jobs; then with the pod-count gate.
    "cross-job-dirty": (lambda pkg: twin_cache(pkg, "mixed"), FLAGSHIP_CONF, {}),
    "pod-count": (lambda pkg: twin_cache(pkg, "mixed"), FLAGSHIP_CONF,
                  dict(enforce_pod_count=True)),
    # Static rows, one a task ([T, N]) and one a signature class.
    "static-rows": (lambda pkg: twin_cache(pkg, "static"), PREDICATES_CONF, {}),
    "static-signatures": (lambda pkg: kubemark_twin(pkg, 32, 300), CONFIG2_CONF, {}),
    # The multi-queue pop: delta, full-recompute and ladder chains, and the
    # 1:9 starvation session (q0 turns overused partway).
    "mq-delta": (lambda pkg: templates(pkg, 16, 60, 4, queues=True), smoke.MULTIQ_CONF, {}),
    "mq-full": (lambda pkg: templates(pkg, 16, 60, 4, queues=True), smoke.MULTIQ_CONF,
                dict(queue_delta=False)),
    "mq-ladder": (lambda pkg: ladder_twin(pkg, 3, 300, 5, 6), smoke.MULTIQ_CONF, {}),
    "mq-starvation": (lambda pkg: build_twin(pkg, smoke.multi_queue_spec((1, 9), 3)),
                      smoke.MULTIQ_CONF, {}),
    # An unsorted single-queue session: the chain selects every pop.
    "unsorted": (lambda pkg: twin_cache(pkg, "mixed"), FLAGSHIP_CONF, dict(sorted_jobs=False)),
    # The releasing arm.
    **{f"releasing-seed{seed}": (lambda pkg, seed=seed: releasing_twin(pkg, seed),
                                 PROPORTION_CONF, {}) for seed in range(3)},
    "releasing-aftermath-2pct": (lambda pkg: aftermath(pkg, 0.02, 1000), smoke.RECLAIM_CONF, {}),
}


def jax_loop(case):
    """The JAX engine on the case's cluster with its mega kernel off: its
    staged operands, its loop kwargs with the case's overrides, and the
    loop's codes."""
    build, conf, overrides = LOOP_CASES[case]
    jssn = open_in("scheduler_tpu", build("scheduler_tpu"), conf)
    from scheduler_tpu.actions.allocate import collect_candidates
    from scheduler_tpu.ops.fused import FusedAllocator

    engine = FusedAllocator(jssn, collect_candidates(jssn))
    engine.use_mega = False
    kw = dict(engine._allocate_kw(), **overrides)
    return engine, kw, np.asarray(jax_fused_allocate(*engine.args, **kw))


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_arm_matches_jax_loop(case):
    build, conf, overrides = LOOP_CASES[case]
    engine, kw, expected = jax_loop(case)
    args, port_kw = fused_operands_from_numpy([np.asarray(a) for a in engine.args], kw, "cpu")
    placed = int(((expected >= 0) | (expected <= fused_mod._PIPE_BASE)).sum())
    assert placed > 0
    arms = ("step_kernel", "xla") if engine.step_kernel and kw["step_kernel"] else ("xla",)
    assert (arms == ("xla",)) == (case in ("score-bound", "static-signatures")
                                  or case.startswith("releasing"))
    for arm in arms:
        before = sk.launches
        codes, stats = fused_mod.fused_allocate(
            *args, **dict(port_kw, step_kernel=arm == "step_kernel"))
        assert sk.launches == before, "the CPU loop launches no kernel"
        np.testing.assert_array_equal(codes.numpy(), expected, err_msg=arm)
        assert stats["arm"] == arm and stats["steps"] > 0
        if case.startswith("mq"):
            chain = "ladder_lookups" if "ladder" in case else (
                "full_recomputes" if "full" in case else "delta_updates")
            assert stats[chain] == stats["chain_selects"] > 0, stats
    if case.startswith("releasing"):
        assert (expected <= fused_mod._PIPE_BASE).any(), "some task must be pipelined"
    assert port_kw["qfair_ladder"] == (case == "mq-ladder")
    if case in ("binpack-runs", "score-bound"):
        assert port_kw["batch_runs"]
    if case == "static-signatures":
        assert port_kw["sig_compress"] and args[9].shape[0] < args[7].shape[0]
    if overrides:
        return
    # The port's own engine on the twin, switched to its loop: the operands
    # it stages (static rows by static signature) give the same codes.
    port = open_port_engine(build, conf)
    port.use_mega = False
    assert port.step_kernel == engine.step_kernel
    assert port.engine == ("step" if port.step_kernel else "xla")
    np.testing.assert_array_equal(port.readback(), expected)
    assert port.run_stats()["steps"] == stats["steps"] or port.step_kernel


def open_port_engine(build, conf):
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.ops.fused import FusedAllocator

    ssn = open_in("scheduler_tpu_torch", build("scheduler_tpu_torch"), conf)
    return FusedAllocator(ssn, collect_candidates(ssn), device="cpu")


# -- 2. the XLA arm's node state -----------------------------------------------------

def test_xla_arm_keeps_its_node_state_on_the_engine_device():
    """The arm's node state is staged on the device of the loop's device
    operands and every step's row add lands there; on the CPU here, so the
    state is a CPU tensor that the steps change in place."""
    engine, kw, _ = jax_loop("score-bound")
    args, port_kw = fused_operands_from_numpy([np.asarray(a) for a in engine.args], kw, "cpu")
    named = dict(zip(fused_mod.FUSED_OPERAND_NAMES, args))
    arm = XlaStep(*(named[k] for k in fused_mod.FUSED_OPERAND_NAMES[:11]),
                  weights=port_kw["weights"], use_static=False, enforce_pod_count=False,
                  has_releasing=False, batch_runs=True, score_bound=True)
    assert arm.node_state.device == named["allocatable"].device
    before = arm.node_state.clone()
    best, feasible, alloc_here, pipe_here, m = arm.step(0, 0, 2)
    assert feasible and alloc_here and not pipe_here and m >= 1
    assert arm.node_state.device.type == "cpu"
    changed = torch.nonzero((arm.node_state != before).any(dim=1)).flatten().tolist()
    assert changed == [best]
    assert float(arm.node_state[best, -1] - before[best, -1]) == m
