"""The port's CUDA kernel on the card (marked ``cuda``: skips without a GPU).

A CUDA kernel has no CPU mode, so these tests run only where
``torch.cuda.is_available()``; the CPU suite reaches the same arithmetic
through the plain version (``test_torch_megakernel.py``).  This file imports
nothing of JAX, so it runs on a GPU machine without it, from the root of a
checkout (``--noconftest``: the suite's conftest imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each case builds a session with the port's harness on the card, launches
a kernel and holds it against its plain version on the same CUDA operands,
bitwise (tolerance: none): ``mega_allocate`` (codes and stats; sessions
and synthetic operands across its launch plans, its qfair-ladder mode and
full-recompute queue chain, its releasing mode), ``qfair_solve`` (deserved rows bit for bit,
met flags, evidence),
``static_predicate_mask`` (the mask; vocabulary widths around its packed
word), ``place_scan`` (codes and the node state it writes; the weights,
ready deficits, pipelines, the pod-count gate, infeasible tasks, rows left
out of a pop and pad node columns, 10,000 nodes and a pop of 100),
``placement_step`` (all four outputs; node counts across its
cluster, ties across CTAs, a pushed column) and the ``fused_allocate``
loop with it (codes, against the loop with the plain version on the
card; in cursor mode and with the multi-queue pop), ``xla_step`` (the five
results and the node state it writes; the planted cases of
``chip_smoke.XLA_STEP_PLANTS`` under several plans, node counts around the
plan's thresholds, 40 and 100 resource dims) and the loop with it (each step checked, codes against
the loop with the plain arm on the card, and against the same arm on the
CPU).  The two batched engines, the eviction hunt
(``SCHEDULER_TORCH_EVICT=device``) on storms and backfill's class engine
(``SCHEDULER_TORCH_BACKFILL=device``) on small waves, on the card equal to
their CPU runs and to the host flavors; K3 on a wave's class rows bitwise
its plain version.  The daemon over the wire on a small config-2 cluster:
K3 and K2 launched, binds equal to ``Scheduler.run_once``'s.
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu_torch.harness import (
    make_gpu_topology_cluster,
    make_kubemark_density_cluster,
    make_mq_ladder_cluster,
    make_reclaim_aftermath_cluster,
    make_synthetic_cluster,
)
from scheduler_tpu_torch.interop import mega_operands_from_numpy
from scheduler_tpu_torch.ops import fused as fused_mod
from scheduler_tpu_torch.ops import megakernel as mk
from scheduler_tpu_torch.ops import place_scan_kernel as psk
from scheduler_tpu_torch.ops import predicate_kernel as pk
from scheduler_tpu_torch.ops import qfair
from scheduler_tpu_torch.ops import step_kernel as sk
from scheduler_tpu_torch.ops import xla_step


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spill_cluster(queues=1):
    """Identical-request gangs larger than one node's room on a cluster too
    small for them all: runs batch, cohorts spill across nodes, and some
    gangs fail.  With ``queues`` > 1 the gangs are dealt to queues q0, q1,
    ... of weights 1, 2, ..."""
    names = tuple(f"q{i}" for i in range(queues)) if queues > 1 else ("default",)
    return make_synthetic_cluster(
        8, 1600, tasks_per_job=100, request_fn=smoke.uniform_gang_request, queues=names,
        queue_weights={q: i + 1 for i, q in enumerate(names)},
    ).cache


# case id -> (cluster builder, conf, kernel-argument overrides)
CASES = {
    "config1": (smoke.config1_cluster, smoke.CONFIG1_CONF, {}),
    "spill-cohort-1": (_spill_cluster, smoke.FLAGSHIP_CONF, {"cohort": 1}),
    "spill-cohort-4": (_spill_cluster, smoke.FLAGSHIP_CONF, {"cohort": 4}),
    "score-bound-pod-count": (
        _spill_cluster, smoke.FLAGSHIP_CONF,
        {"weights": (1.0, 1.0, 1.0), "score_bound": True, "enforce_pod_count": True,
         "cohort": 4},
    ),
    # 12,000 jobs: the compact job ledger outgrows a CTA's shared memory and
    # the kernel keeps one copy a CTA in global scratch.
    "global-job-ledger": (smoke.many_jobs_cluster, smoke.FLAGSHIP_CONF, {}),
    # Static-row mode (predicates + nodeorder).
    "static-cohort-1": (lambda: smoke.spec_cluster(smoke.static_spec()),
                        smoke.PREDICATES_CONF, {"cohort": 1}),
    "static-score-bound-cohort-4": (lambda: smoke.spec_cluster(smoke.selector_bound_spec()),
                                    smoke.PREDICATES_CONF, {"cohort": 4}),
    "static-predicates": (lambda: smoke.spec_cluster(smoke.predicates_spec()),
                          smoke.PRESSURE_CONF, {}),
    "config2-64x600": (lambda: make_kubemark_density_cluster(64, 600).cache,
                       smoke.CONFIG2_CONF, {}),
    # Multi-queue mode, cursor instantiation: three queues of spilling
    # gangs, and the 1:9 starvation shape.
    "mq-spill-3q-cohort-4": (lambda: _spill_cluster(queues=3), smoke.MULTIQ_CONF, {"cohort": 4}),
    "mq-starvation": (lambda: smoke.spec_cluster(smoke.multi_queue_spec((1, 9), 3)),
                      smoke.MULTIQ_CONF, {}),
    # Multi-queue mode, static-row instantiation: the default conf's tiers.
    "mq-config2-default-tiers": (lambda: make_kubemark_density_cluster(64, 600).cache,
                                 smoke.DEFAULT_TIERS_CONF, {"cohort": 4}),
    "mq-config5-default-tiers": (lambda: make_gpu_topology_cluster(75, 50).cache,
                                 smoke.DEFAULT_TIERS_CONF, {}),
    # Releasing mode, multi-queue instantiation: BASELINE config 4 after its
    # reclaim at scale 0.02 (idle slots allocated, the rest pipelined).
    "mq-reclaim-aftermath": (lambda: make_reclaim_aftermath_cluster(0.02).cache,
                             smoke.RECLAIM_CONF, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version(case):
    device = _card()
    build, conf, overrides = CASES[case]
    _, engine = smoke.engine_for(build(), conf, device)
    kw = dict(engine._mega_kw, **overrides)
    assert kw["use_static"] == (conf not in (smoke.FLAGSHIP_CONF, smoke.CONFIG1_CONF,
                                             smoke.MULTIQ_CONF, smoke.RECLAIM_CONF))
    assert kw["multi_queue"] == case.startswith("mq-")
    assert kw["has_releasing"] == (case == "mq-reclaim-aftermath")
    n_queues = len(engine.queue_uids)
    plan = mk.plan_for(engine._mega_args, kw, n_queues)
    assert plan.job_ledger_in_global == (case == "global-job-ledger")
    before = mk.launches
    codes, stats = mk.mega_allocate(*engine._mega_args, n_queues=n_queues, **kw)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref_codes, ref_stats = mk.mega_allocate_reference(*engine._mega_args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(stats, ref_stats)
    assert int((codes >= 0).sum()) > 0
    if kw["multi_queue"]:
        assert int(stats[mk.STATS.QDELTA_UPDATES]) > 0
    if kw["has_releasing"]:
        assert int((codes <= mk.PIPE_BASE).sum()) == 240


@pytest.mark.cuda
def test_cuda_kernel_multi_queue_without_a_queue_chain():
    """Three queues and no proportion (priority and gang only): multi-queue
    mode with no queue chain, the queues popped by rank alone; the kernel
    against its plain version, bitwise."""
    device = _card()
    _, engine = smoke.engine_for(smoke.spec_cluster(smoke.multi_queue_spec()),
                                 smoke.CONFIG1_CONF, device)
    kw = engine._mega_kw
    assert kw["multi_queue"] and not (kw["queue_proportion"] or kw["overused_gate"])
    codes, stats = mk.mega_allocate(*engine._mega_args, n_queues=len(engine.queue_uids), **kw)
    ref_codes, ref_stats = mk.mega_allocate_reference(*engine._mega_args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(stats, ref_stats)
    assert int((codes >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(smoke.MEGA_SYNTHETIC_REL))
def test_cuda_kernel_releasing_synthetic_operands(case):
    """``mega_allocate`` in releasing mode on synthetic operands
    (``chip_smoke.MEGA_SYNTHETIC_REL``) against its plain version, bitwise
    (tolerance: none): the four REL instantiations at r_dim 8 and nb 1,024,
    16,384 and 32,768 (the releasing slice takes the 16-CTA plan there), an
    idle-fit node and a releasing-only node on equal scores in different
    CTAs (either first: the lowest index wins and its idle fit decides),
    releasing-only nodes that score best, and nodes at their pod limits."""
    device = _card()
    spec = smoke.MEGA_SYNTHETIC_REL[case]
    ops, kw = smoke.mega_operands(**spec)
    args, kw = mega_operands_from_numpy(ops, kw, device)
    n_queues = spec.get("queues")
    plan = mk.plan_for(args, kw, n_queues)
    if "nb32768" in case:
        assert plan.ctas == 16
    before = mk.launches
    codes, stats = mk.mega_allocate(*args, n_queues=n_queues, **kw)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref_codes, ref_stats = mk.mega_allocate_reference(*args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(stats, ref_stats)
    assert int((codes <= mk.PIPE_BASE).sum()) > 0 and int(stats[mk.STATS.COHORT_STEPS]) == 0
    if spec.get("gated"):
        n_cover = mk.covered_nodes(ops["gate"])
        ranks = {g // -(-n_cover // plan.ctas) for g in spec["gated"]}
        assert len(ranks) == len(spec["gated"]), "the gated nodes lie in different CTAs"
        first = min(spec["gated"])
        assert int(codes[0]) == (mk.PIPE_BASE - first if first in spec["rel_only"] else first)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(smoke.MEGA_SYNTHETIC_MQ))
def test_cuda_kernel_multi_queue_synthetic_operands(case):
    """``mega_allocate`` in multi-queue mode on synthetic operands
    (``chip_smoke.MEGA_SYNTHETIC_MQ``) against its plain version, bitwise
    (tolerance: none): two to eight queues with one empty, a queue starved
    by its overused gate, equal shares across queues, both instantiations,
    and j_pad 8,320 with the queue ledger and the job ledger on chip."""
    device = _card()
    spec = smoke.MEGA_SYNTHETIC_MQ[case]
    ops, kw = smoke.mega_operands(**spec)
    args, kw = mega_operands_from_numpy(ops, kw, device)
    plan = mk.plan_for(args, kw, spec["queues"])
    assert plan.off_queue is not None
    if case == "mq5-static-8320":
        assert ops["job_off"].shape[1] == 8320 and not plan.job_ledger_in_global
    before = mk.launches
    codes, stats = mk.mega_allocate(*args, n_queues=spec["queues"], **kw)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref_codes, ref_stats = mk.mega_allocate_reference(*args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(stats, ref_stats)
    assert int((codes >= 0).sum()) > 0 and int(stats[mk.STATS.QDELTA_UPDATES]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(smoke.MEGA_SYNTHETIC_LADDER))
def test_cuda_kernel_ladder_synthetic_operands(case):
    """``mega_allocate`` in qfair-ladder mode on synthetic operands
    (``chip_smoke.MEGA_SYNTHETIC_LADDER``; both instantiations) against its
    plain version, bitwise (tolerance: none); then the same operands on the
    full-recompute chain, which places the same."""
    device = _card()
    spec = smoke.MEGA_SYNTHETIC_LADDER[case]
    ops, kw = smoke.ladder_operands(**spec)
    args, kw = mega_operands_from_numpy(ops, kw, device)
    for mode in ({}, {"qfair_ladder": False, "queue_delta": False}):
        mkw = dict(kw, **mode)
        before = mk.launches
        codes, stats = mk.mega_allocate(*args, n_queues=spec["queues"], **mkw)
        torch.cuda.synchronize()
        assert mk.launches == before + 1
        ref_codes, ref_stats = mk.mega_allocate_reference(*args, **mkw)
        assert torch.equal(codes, ref_codes)
        assert torch.equal(stats, ref_stats)
        placed = int((codes >= 0).sum())
        assert placed > 0
        if mode:
            assert int(stats[mk.STATS.QFULL_RECOMPUTES]) == int(stats[mk.STATS.STEPS])
        else:
            assert int(stats[mk.STATS.QFAIR_LOOKUPS]) == placed
            ladder_codes = codes
    assert torch.equal(codes, ladder_codes)


@pytest.mark.cuda
@pytest.mark.parametrize("conf", ["multiq", "default-tiers"])
def test_cuda_kernel_ladder_session(conf):
    """The ladder flagship's shape at small size (``make_mq_ladder_cluster``;
    the multi-queue conf, and the default tiers for static rows): the
    engine stages the ladder, and the kernel equals its plain version and
    the same launch on the delta chain."""
    device = _card()
    text = {"multiq": smoke.MULTIQ_CONF, "default-tiers": smoke.DEFAULT_TIERS_CONF}[conf]
    _, engine = smoke.engine_for(make_mq_ladder_cluster(64, 1200, 12, 6).cache, text, device)
    kw = engine._mega_kw
    assert kw["qfair_ladder"] and kw["use_static"] == (conf == "default-tiers")
    n_queues = len(engine.queue_uids)
    codes, stats = mk.mega_allocate(*engine._mega_args, n_queues=n_queues, **kw)
    ref_codes, ref_stats = mk.mega_allocate_reference(*engine._mega_args, **kw)
    assert torch.equal(codes, ref_codes) and torch.equal(stats, ref_stats)
    delta_codes, _ = mk.mega_allocate(*engine._mega_args, n_queues=n_queues,
                                      **dict(kw, qfair_ladder=False))
    assert torch.equal(codes, delta_codes)
    assert int(stats[mk.STATS.QFAIR_LOOKUPS]) == int((codes >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("q_n,r_n,seed", [(1, 2, 0), (3, 4, 1), (8, 8, 2), (40, 18, 3),
                                          (100, 8, 4), (128, 18, 5), (128, 2, 6),
                                          # the kernel's tiling: a warp a queue, a
                                          # thread a dim and a fold; more queues than
                                          # threads; past shared memory (the global arm)
                                          (1, 40, 9), (33, 2, 10), (33, 3, 11), (33, 40, 12),
                                          (300, 3, 13), (300, 40, 14), (1100, 8, 15),
                                          (1100, 40, 16)])
def test_qfair_solve_matches_plain_version(q_n, r_n, seed):
    """``qfair_solve`` on the card against its plain version on random
    fleets (``chip_smoke.qfair_fleet``), capped and uncapped (tolerance:
    none, float64 bit for bit)."""
    ops = smoke.qfair_fleet(q_n, r_n, seed, _card())
    before = qfair.launches
    got = qfair.qfair_solve(*ops, iters=q_n + 4)
    torch.cuda.synchronize()
    assert qfair.launches == before + 1
    ref = qfair.qfair_solve_reference(*ops, iters=q_n + 4)
    assert torch.equal(got[0].view(torch.int64), ref[0].view(torch.int64))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert int(got[2][1]) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("q_n,r_n,seed,iters", [(0, 2, 0, 4), (0, 3, 1, 0), (33, 3, 15, 1),
                                                (300, 40, 16, 2), (1100, 8, 17, 1)])
def test_qfair_solve_empty_fleet_or_cut_budget(q_n, r_n, seed, iters):
    """No queue (converged at round 0; no round at all with a budget of 0),
    or a round budget that runs out before the fixed point
    (``converged_at`` -1): the kernel against its plain version, bitwise."""
    ops = smoke.qfair_fleet(q_n, r_n, seed, _card())
    got = qfair.qfair_solve(*ops, iters=iters)
    ref = qfair.qfair_solve_reference(*ops, iters=iters)
    assert torch.equal(got[0].view(torch.int64), ref[0].view(torch.int64))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert int(got[2][1]) == (-1 if q_n else (0 if iters else -1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(smoke.MEGA_SYNTHETIC))
def test_cuda_kernel_synthetic_operands(case):
    """``mega_allocate`` on synthetic operands (``chip_smoke.MEGA_SYNTHETIC``)
    against its plain version, bitwise (tolerance: none): nb 1,024, 16,384
    and 32,768 at r_dim 8 (the widest takes the 16-CTA plan), equal scores
    on gated nodes in different CTAs (the lowest index wins), the score
    bound's second-best in another CTA than the winner, a chunk where no
    node fits (FAILED), and config 2's j_pad of 8,320 with the job ledger on
    chip."""
    device = _card()
    spec = smoke.MEGA_SYNTHETIC[case]
    ops, kw = smoke.mega_operands(**spec)
    args, kw = mega_operands_from_numpy(ops, kw, device)
    plan = mk.plan_for(args, kw)
    if case == "nb32768-r8":
        assert plan.ctas == 16
    if case == "job-ledger-on-chip-8320":
        assert ops["job_off"].shape[1] == 8320 and not plan.job_ledger_in_global
    before = mk.launches
    codes, stats = mk.mega_allocate(*args, **kw)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref_codes, ref_stats = mk.mega_allocate_reference(*args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(stats, ref_stats)
    placed = codes[codes >= 0]
    assert placed.numel() > 0
    if spec.get("gated"):
        assert set(placed.tolist()) <= set(spec["gated"])
        n_cover = mk.covered_nodes(ops["gate"])
        ranks = {g // -(-n_cover // plan.ctas) for g in spec["gated"]}
        assert len(ranks) == len(spec["gated"]), "the gated nodes lie in different CTAs"
        if case == "ties-across-ctas":
            assert int(placed[0]) == min(spec["gated"])
    if case == "infeasible-chunk":
        assert int((codes == mk.FAILED).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,l,k", [(1, 1, 0, 0), (3, 5, 4, 2), (130, 200, 7, 3),
                                     (256, 128, 40, 17), (40, 70, 0, 5), (40, 70, 9, 0)])
def test_predicate_kernel_matches_plain_version(t, n, l, k):
    """``static_predicate_mask`` on the card against its plain version, on
    the shapes of tests/test_torch_predicates.py (tolerance: none)."""
    device = _card()
    rng = np.random.default_rng(t * 1000 + n)
    ops = tuple(torch.from_numpy(a).to(device) for a in (
        rng.random((t, l)) < 0.2, rng.random(t) < 0.1, rng.random((n, l)) < 0.5,
        rng.random(n) < 0.15, rng.random((n, k)) < 0.3, rng.random((t, k)) < 0.5))
    before = pk.launches
    mask = pk.static_predicate_mask(*ops)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(mask, pk.static_predicate_mask_reference(*ops))


# Vocabulary widths around the packed word (32 entries) and the staged chunk
# (1,024 entries): every alignment class of the in-kernel packing (16-byte,
# 4-byte and byte rows) and partial last words.
VOCAB = [0, 1, 31, 32, 33, 255, 256, 257, 1004]
SIGS = [1, 3, 33, 4096]
NODES = [1, 31, 1000, 10000]
PACKED_CASES = [(SIGS[i % 4], NODES[(i + i // 4) % 4], L, VOCAB[(3 * i + 2) % 9])
                for i, L in enumerate(VOCAB)]
PACKED_CASES += [(SIGS[(i + 1) % 4], NODES[(i + 2) % 4], VOCAB[(5 * i + 1) % 9], K)
                 for i, K in enumerate(VOCAB)]
PACKED_CASES = sorted(set(PACKED_CASES + [(4096, 10000, 1004, 33)]))


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,l,k", PACKED_CASES)
def test_predicate_kernel_packing_matches_plain_version(s, n, l, k):
    """``static_predicate_mask`` on the card against its plain version
    (tolerance: none) at vocabulary widths around the packed word, with
    about two required label pairs a signature present on most nodes and
    about one taint a node, so both outcomes occur; signatures with
    ``has_unknown`` and unschedulable nodes included."""
    device = _card()
    rng = np.random.default_rng(s * 7 + n * 3 + l * 11 + k)
    unknown = rng.random(s) < 0.1
    unknown[0] = s > 1
    unsched = rng.random(n) < 0.1
    unsched[-1] = n > 1
    ops = tuple(torch.from_numpy(a).to(device) for a in (
        rng.random((s, l)) < 2.0 / max(l, 1), unknown, rng.random((n, l)) < 0.95, unsched,
        rng.random((n, k)) < 1.0 / max(k, 1), rng.random((s, k)) < 0.5))
    before = pk.launches
    mask = pk.static_predicate_mask(*ops)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    ref = pk.static_predicate_mask_reference(*ops)
    assert torch.equal(mask, ref)
    if s * n > 100:
        assert 0 < int(ref.sum()) < s * n


@pytest.mark.cuda
def test_scheduler_on_cuda_binds_as_the_host_loop(tmp_path):
    """``Scheduler.run_once`` on the card (fused route, one kernel launch)
    binds exactly what the port's host loop binds on the same cluster."""
    _card()
    from scheduler_tpu_torch.actions import allocate
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.scheduler import Scheduler

    conf = tmp_path / "conf.yaml"
    conf.write_text(smoke.FLAGSHIP_CONF)
    gpu = make_synthetic_cluster(64, 600, tasks_per_job=10).cache
    launches, fused = mk.launches, allocate.routes["fused"]
    Scheduler(gpu, scheduler_conf=str(conf)).run_once()
    assert mk.launches == launches + 1 and allocate.routes["fused"] == fused + 1
    host = make_synthetic_cluster(64, 600, tasks_per_job=10).cache
    ssn = open_session(host, parse_scheduler_conf(smoke.FLAGSHIP_CONF).tiers, device="cpu")
    AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
    close_session(ssn)
    assert dict(gpu.binder.binds) == dict(host.binder.binds)
    assert len(gpu.binder.binds) == 600


# case id -> (nodes, seed, operand flags, kernel flags)
STEP_CASES = {
    "binpack-capacity": (1024, 1, {}, dict(weights=(0.0, 0.0, 1.0), with_capacity=True)),
    "all-terms-static-pods": (2048, 2, {}, dict(weights=(1.0, 1.0, 1.0), use_static=True,
                                                enforce_pod_count=True, with_capacity=True)),
    "nodeorder-static": (1000, 3, {}, dict(weights=(1.0, 1.0, 0.0), use_static=True)),
    "no-weights": (128, 4, {}, dict(weights=(0.0, 0.0, 0.0), with_capacity=True)),
    "r-dim-3": (4096, 5, {"r_dim": 3}, dict(weights=(1.0, 1.0, 1.0), with_capacity=True)),
    "infeasible": (16384, 6, {"infeasible": True}, dict(weights=(1.0, 1.0, 1.0),
                                                        with_capacity=True,
                                                        enforce_pod_count=True)),
    "ties": (16384, 7, {"ties": True}, dict(weights=(1.0, 1.0, 1.0), with_capacity=True)),
    "nb-65536": (65536, 8, {}, dict(weights=(0.0, 0.0, 1.0), use_static=True,
                                    enforce_pod_count=True, with_capacity=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_kernel_matches_plain_version(case):
    """``placement_step`` on the card against its plain version: all four
    outputs bitwise equal (tolerance: none)."""
    device = _card()
    n, seed, flags, kernel = STEP_CASES[case]
    flags = dict(flags)
    r_dim = flags.pop("r_dim", 2)
    ops = tuple(torch.from_numpy(a).to(device)
                for a in smoke.step_operands(seed, n, r_dim, **flags))
    kw = {"r_dim": r_dim, "r8": 8, "cpu_idx": 0, "mem_idx": 1, "use_static": False,
          "enforce_pod_count": False, "with_capacity": False, **kernel}
    before = sk.launches
    got = smoke._step_tuple(sk.placement_step(*ops, **kw))
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    ref = smoke._step_tuple(sk.placement_step_reference(*ops, **kw))
    assert sk.same_result(got, ref), (got, ref)
    if flags.get("infeasible"):
        assert got[0] == 0 and got[1] == float("-inf")


FULL_STEP = dict(weights=(1.0, 1.0, 1.0), use_static=True, enforce_pod_count=True,
                 with_capacity=True)
BARE_STEP = dict(weights=(0.0, 0.0, 1.0), use_static=False, enforce_pod_count=False,
                 with_capacity=False)


def _step_kw(**flags):
    return {"r_dim": 2, "r8": 8, "cpu_idx": 0, "mem_idx": 1, **flags}


def _step_ops(device, seed, n, **flags):
    return [torch.from_numpy(a).to(device) for a in smoke.step_operands(seed, n, 2, **flags)]


def _run_step(ops, kw):
    before = sk.launches
    got = smoke._step_tuple(sk.placement_step(*ops, **kw))
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    ref = smoke._step_tuple(sk.placement_step_reference(*ops, **kw))
    assert sk.same_result(got, ref), (got, ref)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 1024, 8193, 16384, 65536])
@pytest.mark.parametrize("flags", ["full", "bare"])
def test_step_kernel_node_counts(n, flags):
    """``placement_step`` against its plain version at node counts below
    one group of 4, ragged (not a multiple of 4: scalar loads) and across
    the cluster's 8,192 threads, with every gate and the capacity grid on,
    and with binpack alone (tolerance: none)."""
    device = _card()
    kw = _step_kw(**(FULL_STEP if flags == "full" else BARE_STEP))
    _run_step(_step_ops(device, n, n), kw)


def _alike_nodes(n, **flags):
    """``step_operands`` with every node alike, empty and large enough for
    any request (so each passes the fit and the pod-count gate)."""
    arrays = smoke.step_operands(n, n, 2, ties=True, **flags)
    ns, alloc = arrays[0], arrays[1]
    alloc[:2] = np.array([[64000.0], [262144.0]], np.float32)
    ns[:2] = alloc[:2]
    ns[8] = 0.0
    return arrays


@pytest.mark.cuda
@pytest.mark.parametrize("n,a,b", [(16384, 13000, 5000), (65536, 40000, 9000),
                                   (8193, 8192, 4100), (1024, 1020, 3)])
def test_step_kernel_ties_across_ctas_take_the_lowest_index(n, a, b):
    """Two equal maxima in different CTAs of the cluster (or, at 1,024
    nodes, in different warps): the lower node index wins.  All nodes are
    alike and only ``a`` and ``b`` pass the gate."""
    device = _card()
    arrays = _alike_nodes(n)
    arrays[4][:] = False
    arrays[4][0, [a, b]] = True
    ops = [torch.from_numpy(x).to(device) for x in arrays]
    got = _run_step(ops, _step_kw(**FULL_STEP))
    assert got[0] == min(a, b) and got[1] > float("-inf")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8193, 65536])
@pytest.mark.parametrize("special", ["ties", "infeasible"])
def test_step_kernel_all_equal_or_infeasible_gives_node_0(n, special):
    """Every node alike and feasible: best is node 0.  Nothing feasible:
    best 0 and score -inf."""
    device = _card()
    arrays = _alike_nodes(n, infeasible=special == "infeasible")
    ops = [torch.from_numpy(x).to(device) for x in arrays]
    got = _run_step(ops, _step_kw(**FULL_STEP))
    assert got[0] == 0
    assert (got[1] == float("-inf")) == (special == "infeasible")


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(16384, 7777), (8193, 8192)])
def test_step_kernel_scores_the_pushed_column(n, c):
    """A loop step after the host changed node column ``c``: the kernel
    scores ``c`` with the pushed values (which make it the winner; the
    card's old values leave it infeasible), takes the capacity grid and pod
    room from them, and writes them into the card's node state."""
    device = _card()
    kw = _step_kw(**FULL_STEP)
    arrays = smoke.step_operands(c, n, 2)
    ns, alloc, smask, sscore, gate, plim = arrays[:6]
    alloc[:2, c] = (64000.0, 262144.0)  # room for any request of step_operands
    ns[0, c] = 0.0  # no cpu left on the card's copy: infeasible
    smask[0, c] = gate[0, c] = True
    sscore[0, c] = 1000.0
    ops = [torch.from_numpy(x).to(device) for x in arrays]
    loop = sk.StepLoop.for_one_task(*ops, **kw)
    try:
        assert loop.step(0, -1)[0] != c
        loop.ns_host[:2, c] = alloc[:2, c]  # the host frees node c
        loop.ns_host[8, c] = 0.0
        before = sk.launches
        got = loop.step(0, c)
        assert sk.launches == before + 1
        pushed = torch.from_numpy(loop.ns_host).to(device)
        ref = smoke._step_tuple(sk.placement_step_reference(pushed, *ops[1:], **kw))
        assert sk.same_result(got, ref), (got, ref)
        assert got[0] == c and got[2] > 0 and got[3] == int(plim[0, c])
        assert torch.equal(loop.ns[:9, c].cpu(), torch.from_numpy(loop.ns_host[:9, c]))
    finally:
        loop.close()


@pytest.mark.cuda
def test_step_kernel_refuses_r8_past_its_parameters():
    """r8 above the launch parameters' 16 rows raises in the wrapper."""
    device = _card()
    n, r8 = 64, 24
    f32 = torch.float32
    ops = (torch.zeros((r8 + 8, n), dtype=f32, device=device),
           torch.zeros((r8, n), dtype=f32, device=device),
           torch.ones((1, n), dtype=torch.bool, device=device),
           torch.zeros((1, n), dtype=f32, device=device),
           torch.ones((1, n), dtype=torch.bool, device=device),
           torch.ones((1, n), dtype=f32, device=device),
           torch.zeros((r8, 1), dtype=f32, device=device),
           torch.zeros((r8, 1), dtype=f32, device=device),
           torch.zeros((r8, 1), dtype=f32, device=device))
    kw = dict(_step_kw(**BARE_STEP), r8=r8)
    with pytest.raises(ValueError, match="r8"):
        sk.placement_step(*ops, **kw)


# case id -> (cluster factory, conf, engine the gates choose)
LOOP_CASES = {
    "templates-64x120x8": (lambda: smoke.template_cluster(64, 120, 8), smoke.FLAGSHIP_CONF,
                           "mega"),
    "static": (lambda: smoke.spec_cluster(smoke.static_spec()), smoke.PREDICATES_CONF, "mega"),
    "templates-64x4200": (lambda: smoke.template_cluster(64, 4200, 1), smoke.FLAGSHIP_CONF,
                          "step"),
    # K1 inside the loop's multi-queue pop (path j's twin).
    "templates-mq-64x4200x2": (lambda: smoke.template_cluster(
        64, 4200, 2, queues=smoke.MQ_QUEUES, queue_weights=smoke.MQ_WEIGHTS),
        smoke.MULTIQ_CONF, "step"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_matches_loop_with_plain_step(case):
    """``fused_allocate`` on the card (one placement-step launch a step,
    each held to the plain version) against the same loop with the plain
    version: equal codes."""
    device = _card()
    build, conf, engine = LOOP_CASES[case]
    _, eng = smoke.engine_for(build(), conf, device, engine=engine)
    eng.use_mega = False
    args, kw = eng.args, eng._allocate_kw()
    before = sk.launches
    codes, stats = fused_mod.fused_allocate(*args, **kw, check_every=1)
    assert sk.launches == before + stats["steps"] and stats["checked"] == stats["steps"]
    plain, _ = fused_mod.fused_allocate(*args, **kw, plain_step=True)
    assert torch.equal(codes, plain)
    assert int((codes >= 0).sum()) > 0 and stats["k1_ms"] > 0


# case id -> (cluster factory, conf, engine the gates choose, loop kwargs
# overrides).  Each runs the loop's XLA step arm.
XLA_CASES = {
    # Path i's twin: the top-2 score bound under the default conf's tiers.
    "templates-default-tiers-64x4200x2": (
        lambda: smoke.template_cluster(64, 4200, 2), smoke.DEFAULT_TIERS_CONF, "xla", {}),
    # Path k's twin, and config 4's aftermath at 10 % past the mega gate:
    # the releasing arm.
    "releasing-templates-16x4200": (smoke.releasing_templates_cluster, smoke.FLAGSHIP_CONF,
                                    "xla", {}),
    "reclaim-aftermath-templates-0.1": (
        lambda: make_reclaim_aftermath_cluster(0.1, thin_requests=5000).cache,
        smoke.RECLAIM_CONF, "xla", {}),
    # Static rows by signature with the score bound (config 2 at 64 x 600).
    "config2-64x600": (lambda: make_kubemark_density_cluster(64, 600).cache,
                       smoke.CONFIG2_CONF, "mega", {}),
    # The multi-queue pop on the XLA arm (path j's twin, K1 gated off).
    "templates-mq-64x4200x2": (lambda: smoke.template_cluster(
        64, 4200, 2, queues=smoke.MQ_QUEUES, queue_weights=smoke.MQ_WEIGHTS),
        smoke.MULTIQ_CONF, "step", dict(step_kernel=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_xla_arm_on_the_card_matches_the_cpu(case):
    """The loop's XLA step arm on the card against the same arm on the CPU,
    on the operands of one engine per device built from twin clusters:
    equal codes, one ``xla_step`` launch a step and no other loop kernel,
    the node state on the card."""

    device = _card()
    build, conf, engine, overrides = XLA_CASES[case]
    codes = {}
    for dev in (device, torch.device("cpu")):
        _, eng = smoke.engine_for(build(), conf, dev, engine=engine)
        eng.use_mega = False
        kw = dict(eng._allocate_kw(), **overrides)
        seen = []
        init = xla_step.XlaStep.__init__

        def spy(arm, *a, init=init, seen=seen, **k):
            init(arm, *a, **k)
            seen.append(arm)

        xla_step.XlaStep.__init__ = spy
        try:
            before = (sk.launches, mk.launches)
            before_x = xla_step.launches
            codes[dev.type], stats = fused_mod.fused_allocate(*eng.args, **kw)
        finally:
            xla_step.XlaStep.__init__ = init
        assert (sk.launches, mk.launches) == before
        assert stats["arm"] == "xla" and stats["steps"] > 0
        if dev.type == "cuda":
            assert xla_step.launches == before_x + stats["steps"]
        assert seen and seen[0].node_state.device.type == dev.type
        if dev.type == "cuda":
            assert stats["xla_ms"] > 0
    assert torch.equal(codes["cuda"], codes["cpu"])
    placed = (codes["cuda"] >= 0) | (codes["cuda"] <= fused_mod._PIPE_BASE)
    assert int(placed.sum()) > 0
    if "releas" in case or "reclaim" in case:
        assert int((codes["cuda"] <= fused_mod._PIPE_BASE).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_xla_loop_matches_loop_with_plain_arm(case):
    """``fused_allocate`` on the card with the ``xla_step`` kernel, each step
    held to the plain version on a clone of the node state (results and
    the node state it writes), against the same loop with the plain arm on
    the card: equal codes."""
    device = _card()
    build, conf, engine, overrides = XLA_CASES[case]
    _, eng = smoke.engine_for(build(), conf, device, engine=engine)
    eng.use_mega = False
    args, kw = eng.args, dict(eng._allocate_kw(), **overrides)
    before = xla_step.launches
    codes, stats = fused_mod.fused_allocate(*args, **kw, check_every=1)
    assert stats["arm"] == "xla"
    assert xla_step.launches == before + stats["steps"] and stats["checked"] == stats["steps"]
    plain, plain_stats = fused_mod.fused_allocate(*args, **kw, plain_step=True)
    assert xla_step.launches == before + stats["steps"]
    assert torch.equal(codes, plain) and plain_stats["steps"] == stats["steps"]
    assert stats["xla_ms"] > 0 and stats["xla_host_ms"] > 0


# The XLA step kernel's launch plans: the default (1,024 threads at the
# planted cases' 3,000 nodes, three strides) and forced thread counts.
XLA_PLANS = [None, 128, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("threads", XLA_PLANS)
@pytest.mark.parametrize("kind", sorted(smoke.XLA_STEP_PLANTS))
def test_xla_step_planted_case_matches_plain(kind, threads):
    """Each planted case (``chip_smoke.XLA_STEP_PLANTS``, its nodes placed by
    the plan's thread count) under a forced plan: one launch, whose five
    results and written node state equal the plain version's on a clone."""
    device = _card()
    n = smoke.XLA_STEP_PLANTS[kind][0]
    plan = None if threads is None else xla_step.step_plan(n, threads)
    ops, flags, hi0, roles = smoke.xla_plant_case(kind, plan)
    arm = smoke.xla_arm_on(ops, flags, device, plan=plan, check_every=1)
    before = xla_step.launches
    try:
        got = arm.step(0, 0, hi0)
    finally:
        arm.close()
    torch.cuda.synchronize()
    assert xla_step.launches == before + 1 and arm.checked == 1
    if "best" in roles:
        assert got[0] == roles["best"]
    assert (got[1] is False) == (kind == "infeasible")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 16_384, 70_000])
def test_xla_step_node_counts(n):
    """Random operands at node counts around the plan's thresholds (one
    node a thread, then strided, past the placement-step kernel's 65,536
    nodes too), 24 steps of rotating task rows, static rows and caps, each
    held to the plain version on a clone."""
    device = _card()
    ops = smoke.xla_step_operands(n % 97, n, 3)
    ops["resreq"][:, :2] = ops["init_resreq"][:, :2] = np.floor(ops["resreq"][:, :2] / 16)
    arm = smoke.xla_arm_on(ops, smoke.XLA_STEP_FLAGS, device, check_every=1)
    try:
        seen = [arm.step(k % 4, k % 3, (1, 2, 128)[k % 3]) for k in range(24)]
    finally:
        arm.close()
    assert arm.checked == 24 and arm.xla_ms > 0
    assert any(ok for _, ok, _, _, _ in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("r_dim,threads", [(40, None), (100, 128)])
def test_xla_step_many_dims(r_dim, threads):
    """More resource dims than a warp's lanes (40), and a node row wider
    than the CTA (100 dims, 201 columns, on 128 threads): 24 steps, each
    held to the plain version on a clone."""
    device = _card()
    n = 3000
    ops = smoke.xla_step_operands(r_dim, n, r_dim)
    ops["resreq"][:, :2] = ops["init_resreq"][:, :2] = np.floor(ops["resreq"][:, :2] / 16)
    ops["resreq"][:, 2:] = ops["init_resreq"][:, 2:] = 0.0
    ops["resreq"][:, [2, -1]] = ops["init_resreq"][:, [2, -1]] = 1.0
    plan = None if threads is None else xla_step.step_plan(n, threads)
    arm = smoke.xla_arm_on(ops, smoke.XLA_STEP_FLAGS, device, plan=plan, check_every=1)
    try:
        seen = [arm.step(k % 4, k % 3, (1, 2, 128)[k % 3]) for k in range(24)]
    finally:
        arm.close()
    assert arm.checked == 24
    assert any(ok for _, ok, _, _, _ in seen)


@pytest.mark.cuda
def test_xla_step_plan_the_card_cannot_run_raises():
    """A plan outside the kernel's thread counts, or a task row outside the
    operands, is refused: nothing falls back."""
    device = _card()
    ops = smoke.xla_step_operands(1, 3000, 2)
    before = xla_step.launches
    for bad in (xla_step.StepPlan(100, 30), xla_step.StepPlan(2048, 2)):
        with pytest.raises(RuntimeError):
            smoke.xla_arm_on(ops, smoke.XLA_STEP_FLAGS, device, plan=bad)
    arm = smoke.xla_arm_on(ops, smoke.XLA_STEP_FLAGS, device)
    try:
        with pytest.raises(RuntimeError):
            arm.step(len(ops["resreq"]), 0, 1)
        with pytest.raises(RuntimeError):
            arm.step(0, len(ops["static_mask"]), 1)
    finally:
        arm.close()
    assert xla_step.launches == before


# -- the resident engine across cycles (ops/engine_cache.py) ------------------------

HIT_CASES = {
    # Contended flagship gangs (K2's cursor mode): some gangs never fit.
    "flagship_8_x_600": (lambda: make_synthetic_cluster(8, 600, tasks_per_job=10).cache,
                         smoke.FLAGSHIP_CONF),
    # Config 2 past its pod room under the default tiers (K3, then K2's
    # multi-queue mode with static rows): 320 pods stay pending.
    "config2_default_tiers_8_x_1200": (lambda: make_kubemark_density_cluster(8, 1200).cache,
                                       smoke.DEFAULT_TIERS_CONF),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HIT_CASES))
def test_engine_cache_hit_codes_equal_a_cold_engine(case):
    """Two cycles (miss, rebuild), one bound pod completes, and the third
    session hits the resident engine with one node row refreshed in place:
    the hit's K2 codes and stats, launched eagerly, equal those of an
    engine built cold on the same session."""
    card = _card()
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, get_action, open_session
    from scheduler_tpu_torch.ops import engine_cache
    from scheduler_tpu_torch.utils import phases

    build, conf_text = HIT_CASES[case]
    cache = build()
    tiers = parse_scheduler_conf(conf_text).tiers
    engine_cache.clear()
    outcomes = []
    for _ in range(2):
        phases.begin()
        ssn = open_session(cache, tiers, device=card)
        get_action("allocate").execute(ssn)
        close_session(ssn)
        outcomes.append(phases.take_notes()["engine_cache"])
        phases.end()
    assert outcomes == ["miss", "rebuild"]
    bound = min((t for job in cache.jobs.values() for t in job.tasks.values() if t.node_name),
                key=lambda t: t.name)
    cache.delete_pod(bound.pod)
    phases.begin()
    ssn = open_session(cache, tiers, device=card)
    cands = collect_candidates(ssn)
    launches = mk.launches
    engine, status = engine_cache.get_engine(ssn, cands, eager_dispatch=True)
    dirty = phases.take_notes()["dirty"]
    phases.end()
    assert status == "hit" and engine.use_mega and mk.launches == launches + 1
    assert dirty["mode"] == "sparse" and dirty["rows_scattered"] >= 1
    codes = engine.readback().copy()
    stats = engine._stats_raw.copy()
    cold = fused_mod.FusedAllocator(ssn, cands, device=card)
    np.testing.assert_array_equal(codes, cold.readback())
    np.testing.assert_array_equal(stats, cold._stats_raw)
    close_session(ssn)
    engine_cache.clear()


@pytest.mark.cuda
def test_refreshed_owned_buffer_equals_a_fresh_upload():
    """On the card: the first refresh of a shared transfer-cache resident
    replaces it with the engine's own copy (the resident keeps its bytes),
    the next writes that copy in place, and each equals a fresh upload of
    the refreshed host rows; K2's node ledger follows."""
    card = _card()
    from scheduler_tpu_torch.framework import close_session
    from scheduler_tpu_torch.ops import transfer_cache

    transfer_cache.clear()
    cache = make_synthetic_cluster(8, 60, tasks_per_job=6).cache
    ssn, eng = smoke.engine_for(cache, smoke.FLAGSHIP_CONF, card)
    shared = eng._dyn_dev["idle"]
    before = shared.clone()
    close_session(ssn)
    for node, cpu_used in (("hn-000003", 500.0), ("hn-000005", 250.0)):
        ssn, _ = smoke.engine_for(cache, smoke.FLAGSHIP_CONF, card)
        led = ssn.nodes.ledger
        led.idle[led.row_of[node], 0] -= cpu_used
        eng._refresh_epoch = -1
        assert eng._refresh_dynamic(ssn)
        close_session(ssn)
        owned = eng._dyn_dev["idle"]
        assert eng._dyn_owned["idle"] and owned is not shared and owned.is_cuda
        assert torch.equal(owned.cpu(), torch.from_numpy(eng._host_dyn["idle"].copy()))
        assert torch.equal(eng._mega_args[0][0, :8].cpu(), owned[:8, 0].cpu())
        assert torch.equal(shared, before)
    assert float(owned[5, 0]) == float(before[5, 0]) - 250.0
    assert float(owned[3, 0]) == float(before[3, 0])


@pytest.mark.cuda
def test_static_mask_memo_skips_the_kernel():
    """A second build on the same cluster (the same node generation) finds
    every signature row in the cache's memo: K3 launches zero times and the
    static rows are the first build's."""
    card = _card()
    cache = make_kubemark_density_cluster(64, 600).cache
    launches = pk.launches
    _, first = smoke.engine_for(cache, smoke.CONFIG2_CONF, card)
    assert pk.launches > launches
    launches = pk.launches
    _, second = smoke.engine_for(cache, smoke.CONFIG2_CONF, card)
    assert pk.launches == launches
    names = dict(zip(mk.OPERAND_NAMES, first._mega_args))
    again = dict(zip(mk.OPERAND_NAMES, second._mega_args))
    assert torch.equal(names["smask"], again["smask"])
    assert torch.equal(names["sscore"], again["sscore"])


# -- place_scan against its plain version ------------------------------------------

# case id -> (scan_operands kwargs, weights, ready deficit or None (the pop's
# length), enforce_pod_count, rows left out of the pop, pad node columns[,
# extras]).  Extras: "plan", a forced launch plan (CTAs or None for the
# default count, arm or None); "plant", a chip_smoke.plant_scan kind planted
# at the plan's node slices; "fails", the first task finds no node.
ZERO = (0.0, 0.0, 0.0)
SCAN_CASES = {
    "none": (dict(seed=1, n=97, t=24), (0.0, 0.0, 0.0), None, False, 0, 0),
    "least-pod-count": (dict(seed=2, n=97, t=24), (1.0, 0.0, 0.0), None, True, 0, 0),
    "balanced-no-score": (dict(seed=3, n=97, t=24, score=False), (0.0, 1.0, 0.0), None, True,
                          0, 0),
    "binpack-pipelines": (dict(seed=5, n=12, t=32), (0.0, 0.0, 1.0), None, False, 0, 0),
    "nodeorder": (dict(seed=4, n=300, t=40), (1.0, 1.0, 0.0), None, True, 0, 0),
    "all-weights": (dict(seed=6, n=300, t=40), (2.0, 1.0, 0.5), None, True, 0, 0),
    "deficit-0": (dict(seed=7, n=40, t=16), (1.0, 1.0, 0.0), 0, True, 0, 0),
    "deficit-negative": (dict(seed=8, n=40, t=16), (1.0, 1.0, 0.0), -3, True, 0, 0),
    "deficit-1": (dict(seed=9, n=40, t=16), (1.0, 1.0, 0.0), 1, True, 0, 0),
    "deficit-5": (dict(seed=10, n=40, t=16), (1.0, 1.0, 0.0), 5, False, 0, 0),
    "infeasible-first": (dict(seed=11, n=30, t=12, infeasible=True), (1.0, 0.0, 0.0), None,
                         True, 0, 0),
    "pad-rows": (dict(seed=12, n=33, t=16), (1.0, 1.0, 0.0), None, True, 4, 0),
    "pad-columns": (dict(seed=13, n=1000, t=30, n_rows=200), (1.0, 1.0, 0.0), None, True, 0,
                    24),
    "scalar-dims": (dict(seed=14, n=64, t=16, r_dim=5), (2.0, 1.0, 0.5), None, True, 0, 0),
    "north-star-pop": (dict(seed=15, n=10_000, t=100, n_rows=1000), (1.0, 1.0, 0.0), 100, True,
                       0, 6384),
    "north-star-binpack": (dict(seed=16, n=10_000, t=100), (0.0, 0.0, 1.0), None, False, 0, 0),
    # The cluster's node slices: ties and winners at their edges.
    "ties-across-ctas": (dict(seed=17, n=10_000, t=40), ZERO, None, True, 0, 0,
                         {"plant": "ties"}),
    "ties-across-ctas-global": (dict(seed=17, n=10_000, t=40), ZERO, None, True, 0, 0,
                                {"plant": "ties", "plan": (None, "global")}),
    "slice-edges": (dict(seed=18, n=10_000, t=40), ZERO, None, True, 0, 0, {"plant": "edges"}),
    "slice-edges-8-ctas": (dict(seed=18, n=10_000, t=40), ZERO, None, True, 0, 0,
                           {"plant": "edges", "plan": (8, "shared")}),
    "ranks-first-and-last": (dict(seed=19, n=10_000, t=12), ZERO, None, True, 0, 0,
                             {"plant": "ranks"}),
    "ranks-first-and-last-global": (dict(seed=19, n=10_000, t=12), ZERO, None, True, 0, 0,
                                    {"plant": "ranks", "plan": (16, "global")}),
    # Node counts around the plan's cuts, and none at all.
    "n-active-1": (dict(seed=55, n=1, t=6), (1.0, 1.0, 0.0), None, True, 0, 24),
    "n-active-7": (dict(seed=21, n=7, t=12), (1.0, 1.0, 0.0), None, True, 0, 9),
    "n-active-7-16-ctas": (dict(seed=21, n=7, t=12), (1.0, 1.0, 0.0), None, True, 0, 9,
                           {"plan": (16, "shared")}),
    "n-active-10001": (dict(seed=22, n=10_001, t=50), (1.0, 1.0, 0.0), None, True, 0, 0),
    "n-active-0": (dict(seed=23, n=0, t=5), (1.0, 1.0, 0.0), None, True, 0, 24,
                   {"fails": True}),
    # The widest vocabulary: the default (shared) plan and the global arm.
    "r32-shared": (dict(seed=24, n=10_000, t=30, r_dim=32), (2.0, 1.0, 0.5), None, True, 0, 0,
                   {"plan": (None, "shared")}),
    "r32-global": (dict(seed=24, n=10_000, t=30, r_dim=32), (2.0, 1.0, 0.5), None, True, 0, 0,
                   {"plan": (None, "global")}),
    # The engine's mask stride (16,384) with pad columns, on the global arm.
    "stride-16384-global": (dict(seed=15, n=10_000, t=100, n_rows=1000), (1.0, 1.0, 0.0), 100,
                            True, 0, 6384, {"plan": (None, "global")}),
    "ready-break-mid-pop": (dict(seed=26, n=3000, t=60), (1.0, 1.0, 0.0), 7, True, 0, 0),
}


def _scan_plan(case, t):
    """The case's forced launch plan, or None (the wrapper's own)."""
    kw, weights, _, enforce, _, _, *extra = SCAN_CASES[case]
    forced = (extra[0] if extra else {}).get("plan")
    if forced is None:
        return None
    return psk.scan_plan(kw["n"], kw.get("r_dim", 2), t, weights, enforce, *forced)


def _scan_args(case, device):
    """The case's operands on ``device`` (node state copies the scan may
    write), its call arguments and its launch plan (None: the wrapper's)."""
    kw, weights, deficit, enforce, pad_rows, pad_cols, *extra = SCAN_CASES[case]
    extra = extra[0] if extra else {}
    ops = smoke.scan_operands(**kw)
    n = kw["n"]
    plan = _scan_plan(case, kw["t"])
    if "plant" in extra:
        shown = plan or psk.scan_plan(n, kw.get("r_dim", 2), kw["t"], weights, enforce)
        smoke.plant_scan(ops, extra["plant"], psk.node_slices(n, shown))

    def cols(a, fill):
        return np.concatenate([a, np.full((pad_cols,) + a.shape[1:], fill, a.dtype)])

    def dev(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = [dev(cols(ops["idle"], 1e6)), dev(cols(ops["releasing"], 1e6)),
             dev(cols(ops["task_count"], 0)), dev(cols(ops["allocatable"], 1e6)),
             dev(cols(ops["pods_limit"], 100)), dev(ops["mins"])]
    mask = np.concatenate([ops["static_mask"], np.ones((len(ops["static_mask"]), pad_cols),
                                                       bool)], axis=1)
    score = ops["static_score"]
    if score is not None:
        score = np.concatenate([score, np.full((len(score), pad_cols), 1e6, np.float32)],
                               axis=1)
    rows = ops["rows"]
    t = len(rows)
    if pad_rows:
        # The JAX layout's pad rows (the last ``pad_rows`` and one in the
        # middle) are left out of the pop's rows.
        keep = np.ones(t, bool)
        keep[-pad_rows:] = False
        keep[t // 3] = False
        rows = rows[keep]
    rest = [dev(ops["init_resreq"]), dev(ops["resreq"]), dev(mask), dev(score), dev(rows),
            t if deficit is None else deficit, weights, enforce, n]
    return state, rest, plan


def _scan_equal_plain(state_k, rest, plan):
    """One launch with ``plan`` against the plain version on copies of the
    same operands: codes and the node state it writes, bitwise.  Returns
    the codes."""
    state_p = [x.clone() for x in state_k]
    before = psk.launches
    codes = psk.place_scan(*state_k, *rest, plan=plan)
    torch.cuda.synchronize()
    assert psk.launches == before + 1
    plain = psk.place_scan_reference(*state_p, *rest)
    assert torch.equal(codes, plain)
    for a, b in zip(state_k[:3], state_p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return codes


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_place_scan_matches_plain(case):
    device = _card()
    state_k, rest, plan = _scan_args(case, device)
    codes = _scan_equal_plain(state_k, rest, plan)
    extra = SCAN_CASES[case][6] if len(SCAN_CASES[case]) > 6 else {}
    if extra.get("fails"):
        assert int(codes[2, 0]) == 1 and (codes[0] == -1).all()
    else:
        assert (codes[0] >= 0).any() or case == "infeasible-first"
    if "plant" in extra:
        assert int(codes[0, 0]) >= 0  # a planted node won the first task


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["shared", "global"])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
def test_place_scan_every_plan(ctas, arm):
    """Every plan the wrapper can pick (and the ones it can be given), on
    the same operands: 3,000 nodes, a pop of 40 with a ready break at 30."""
    device = _card()
    kw = dict(seed=27, n=3000, t=40)
    ops = smoke.scan_operands(**kw)
    plan = psk.scan_plan(3000, 2, 40, (1.0, 1.0, 0.0), True, ctas, arm)
    assert (plan.ctas, plan.on_chip) == (ctas, arm == "shared")

    def dev(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = [dev(ops[k]) for k in ("idle", "releasing", "task_count", "allocatable",
                                     "pods_limit", "mins")]
    rest = [dev(ops[k]) for k in ("init_resreq", "resreq", "static_mask", "static_score",
                                    "rows")] + [30, (1.0, 1.0, 0.0), True, 3000]
    codes = _scan_equal_plain(state, rest, plan)
    assert int((codes[0] >= 0).sum()) >= 30


@pytest.mark.cuda
def test_place_scan_plan_the_card_cannot_run_raises():
    """A plan past the card's shared memory, or with another CTA size than
    the kernel's, is refused by the entry point and the wrapper raises:
    nothing runs, nothing falls back."""
    device = _card()
    state, rest, _ = _scan_args("nodeorder", device)
    plan = psk.scan_plan(300, 2, 40, (1.0, 1.0, 0.0), True)
    before = psk.launches
    for bad in (psk.ScanPlan(plan.ctas, plan.slice, True, psk.SMEM_LIMIT + 4096, plan.threads),
                psk.ScanPlan(plan.ctas, plan.slice, plan.on_chip, plan.smem_bytes, psk.THREADS)):
        with pytest.raises(RuntimeError):
            psk.place_scan(*state, *rest, plan=bad)
    assert psk.launches == before


@pytest.mark.cuda
def test_place_scan_launch_refuses_cpu_tensors():
    """The kernel's launch takes CUDA tensors only, and the wrapper refuses
    operands on two devices: no silent fallback."""
    device = _card()
    state, rest, _ = _scan_args("none", "cpu")
    with pytest.raises(ValueError):
        psk._launch(*state, *rest, psk.scan_plan(97, 2, 24, (0.0, 0.0, 0.0), False))
    state_dev = [x.to(device) for x in state]
    with pytest.raises(ValueError):
        psk.place_scan(*state_dev, *rest)


# -- the two batched engines of preempt/reclaim and backfill on the card --------------

EVICT_STORMS = {"storm-7-2q": (7, 2), "storm-42-1q": (42, 1), "saturated": None}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EVICT_STORMS))
def test_evict_engine_on_card_equals_cpu(case):
    """``SCHEDULER_TORCH_EVICT=device`` on the card: a storm's evictions in
    commit order, statuses and binds equal to the same flavor on the CPU
    and to the host walk on the card, the engine engaged with the CPU
    run's counters."""
    _card()
    spec = EVICT_STORMS[case]

    def run(device, flavor):
        if spec is None:
            return smoke.saturated_storm_run(device, flavor)
        return smoke.storm_run(*spec, device, flavor)

    card, cpu, host = run(None, "device"), run("cpu", "device"), run(None, "host")
    for key in ("evictions", "statuses", "binds"):
        assert card[key] == cpu[key] == host[key], key
    kinds = ("preempt",) if spec is None else ("reclaim", "preempt")
    smoke.check_engaged(card["evict"], case, kinds)
    strip = {k: {n: v for n, v in s.items() if n != "phase"} for k, s in card["evict"].items()}
    assert strip == {k: {n: v for n, v in s.items() if n != "phase"}
                     for k, s in cpu["evict"].items()}


def _wave_run(tmp_path, device, flavor, **cfg):
    from scheduler_tpu_torch.harness.backfill_wave import (
        BACKFILL_CONF,
        BackfillWaveConfig,
        seed_wave_cache,
    )

    conf = tmp_path / "backfill.yaml"
    conf.write_text(BACKFILL_CONF)
    with smoke.MaskCapture() as cap:
        rec, launches, outcome, wrong = smoke.backfill_cycle(
            seed_wave_cache(BackfillWaveConfig(**cfg)), str(conf), device, flavor)
    assert not wrong
    return rec, launches, outcome, cap.calls


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,pods", [(64, 600), (16, 400)])
def test_backfill_engine_on_card_equals_cpu(tmp_path, nodes, pods):
    """``SCHEDULER_TORCH_BACKFILL=device`` on the card on a small wave:
    binds and FitErrors strings equal to the same flavor on the CPU and to
    the host sweep on the card; K3 built the class rows (one launch), the
    evidence counters equal the CPU run's."""
    _card()
    card, launches, out, _ = _wave_run(tmp_path, None, "device", nodes=nodes, wave_pods=pods)
    cpu, _, cpu_out, _ = _wave_run(tmp_path, "cpu", "device", nodes=nodes, wave_pods=pods)
    _, _, host_out, _ = _wave_run(tmp_path, None, "host", nodes=nodes, wave_pods=pods)
    assert out == cpu_out == host_out
    assert card["backfill"]["engaged"] and launches["static_predicate_mask"] == 1
    strip = {k: v for k, v in card["backfill"].items() if k != "phase"}
    assert strip == {k: v for k, v in cpu["backfill"].items() if k != "phase"}


@pytest.mark.cuda
def test_backfill_class_rows_bitwise(tmp_path):
    """K3 on a wave's signature operands equals its plain version bitwise,
    and the engine's class rows built on the card equal those built on the
    CPU."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.harness.backfill_wave import (
        BACKFILL_CONF,
        BackfillWaveConfig,
        seed_wave_cache,
    )
    from scheduler_tpu_torch.ops.backfill import BackfillEngine
    from scheduler_tpu_torch.plugins.predicates import signature_rows

    device = _card()
    _, _, _, calls = _wave_run(tmp_path, None, "device", nodes=128, wave_pods=1200)
    (st, rep_rows), = calls
    ops = smoke.predicate_operands(st, device)
    assert torch.equal(pk.static_predicate_mask(*ops), pk.static_predicate_mask_reference(*ops))
    assert signature_rows(st)[1].shape[0] == 5
    rows = {}
    for dev in (None, "cpu"):
        cache = seed_wave_cache(BackfillWaveConfig(nodes=128, wave_pods=1200))
        ssn = open_session(cache, parse_scheduler_conf(BACKFILL_CONF).tiers, device=dev)
        engine = BackfillEngine(ssn)
        engine._enabled = ("predicates",)
        rows[dev] = engine._task_mask(st, rep_rows)
        close_session(ssn)
    assert rows[None].shape == (rep_rows.shape[0], 128)
    np.testing.assert_array_equal(rows[None], rows["cpu"])


@pytest.mark.cuda
def test_daemon_over_the_wire_binds_as_run_once(tmp_path):
    """The port's daemon (``cli.main`` with ``--api-server``, on the card)
    over its mock API server on a small config-2 cluster: every pod bound,
    K3 and K2 launched, the binds those of ``Scheduler.run_once`` on the
    same documents preloaded in this process (``chip_smoke.daemon_config2``,
    path q at 64 nodes x 600 pods)."""
    _card()
    rec = smoke.daemon_config2(64, 600, str(tmp_path), limit_s=120)
    assert rec["launches"]["static_predicate_mask"] >= 1
    assert rec["launches"]["mega_allocate"] >= 1
    assert rec["binds"] == 600 and rec["equal_to_twin"]
