"""The port's mega kernel against the JAX one, on the CPU.

``scheduler_tpu_torch.ops.megakernel.mega_allocate`` on CPU tensors runs its
plain PyTorch version (``mega_allocate_reference``), the line-by-line twin
of the CUDA kernel.  These tests stage a session with the JAX package's
``FusedAllocator``, run the JAX ``mega_allocate`` (interpret mode on the
CPU, as the JAX suite runs it), convert the same operands with
``interop.mega_operands_from_numpy`` and run the port: codes and all eight
stats must be bitwise equal (tolerance: none).  They also pin the port's
own engine build: the same cluster built in both packages stages the same
operands.

The twin-cluster builder here (``build_twin``) is shared with
``test_torch_allocate.py``.
"""

import importlib
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu.actions.allocate import collect_candidates as jax_candidates
from scheduler_tpu.conf import parse_scheduler_conf as jax_conf
from scheduler_tpu.framework import open_session as jax_open
from scheduler_tpu.ops.fused import FusedAllocator as JaxFused
from scheduler_tpu.ops.megakernel import mega_allocate as jax_mega
from scheduler_tpu_torch.actions.allocate import collect_candidates as torch_candidates
from scheduler_tpu_torch.conf import parse_scheduler_conf as torch_conf
from scheduler_tpu_torch.framework import open_session as torch_open
from scheduler_tpu_torch.interop import mega_operands_from_numpy
from scheduler_tpu_torch.ops import fused as fused_mod
from scheduler_tpu_torch.ops import megakernel as mk
from scheduler_tpu_torch.ops.fused import FusedAllocator as TorchFused
import chip_smoke as smoke
from chip_smoke import predicates_spec, selector_bound_spec, spec_cluster, static_spec

FLAGSHIP_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: binpack
"""

# The flagship conf plus nodeorder with its static node-affinity scorer off:
# no static rows are staged, and the least-requested and balanced weights
# turn the kernel's top-2 score bound on.
SCORE_BOUND_CONF = FLAGSHIP_CONF + """  - name: nodeorder
    arguments:
      nodeaffinity.weight: 0
"""

# tests/test_megakernel.py's conf for static rows.
PREDICATES_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: predicates
  - name: nodeorder
"""

# BASELINE config 2 (scripts/scenario_ladder.py scenario 2).
CONFIG2_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: predicates
  - name: nodeorder
"""

# Config 2's plugins with the memory-pressure gate on (the predicates twin).
PRESSURE_CONF = CONFIG2_CONF.replace(
    "  - name: predicates\n",
    "  - name: predicates\n    arguments:\n      predicate.MemoryPressureEnable: \"true\"\n",
)

GIB = 2.0**30


# -- one cluster, built in either package -----------------------------------------

def mixed_spec():
    """tests/test_megakernel.py ``_mixed_cluster``: 8 nodes, six 6-task gangs
    of mixed cpu requests, and four single-task jobs (cross-job batching)."""
    rnd = random.Random(11)
    nodes = [(f"n{i}", {"cpu": 4000.0, "memory": 8 * GIB, "pods": 9}) for i in range(8)]
    groups, pods = [], []
    for g in range(6):
        groups.append((f"g{g}", 3))
        for i in range(6):
            pods.append((f"g{g}-{i}", f"g{g}",
                         {"cpu": float(rnd.choice([250, 500, 750])), "memory": GIB}, g % 3))
    for s in range(4):
        groups.append((f"solo{s}", 1))
        pods.append((f"solo{s}-0", f"solo{s}", {"cpu": 100.0, "memory": GIB / 4}, 0))
    return {"nodes": nodes, "groups": groups, "pods": pods}


def spill_spec():
    """tests/test_cohort_parity.py ``_spill_cluster``: identical-request gangs
    much larger than one node's cpu room, so every cohort spills."""
    nodes = [(f"n{i}", {"cpu": 1600.0, "memory": 64 * GIB, "pods": 110}) for i in range(6)]
    groups, pods = [], []
    for g in range(3):
        groups.append((f"g{g}", 10))
        pods += [(f"g{g}-{i}", f"g{g}", {"cpu": 500.0, "memory": GIB}, g % 2)
                 for i in range(10)]
    return {"nodes": nodes, "groups": groups, "pods": pods}


def config1_spec():
    """BASELINE config 1 (example/job.yaml): a 3-task gang on 3 nodes."""
    nodes = [(f"n{i}", {"cpu": 2000.0, "memory": 4 * GIB, "pods": 110}) for i in range(3)]
    pods = [(f"qj-{t}", "qj", {"cpu": 1000.0, "memory": GIB}, 0) for t in range(3)]
    return {"nodes": nodes, "groups": [("qj", 3)], "pods": pods}


def dynamic_spec():
    """Scan-dynamic predicates: pods with a host port and with inter-pod
    affinity and anti-affinity beside ordinary gangs.  Their jobs are
    created last, so they rank below every ordinary job and take the host
    loop after the others take the fused route."""
    nodes = [(f"n{i}", {"cpu": 4000.0, "memory": 8 * GIB, "pods": 20},
              {"labels": {"zone": f"z{i % 2}"}}) for i in range(6)]
    groups = [("web", 3), ("bulk", 2), ("ports", 1), ("near", 1), ("apart", 1)]
    web = {"labels": {"app": "web"}}
    pods = [(f"web-{i}", "web", {"cpu": 1000.0, "memory": GIB}, 2, web) for i in range(3)]
    pods += [(f"ports-{i}", "ports", {"cpu": 500.0, "memory": GIB}, 0,
              {"host_ports": [8080]}) for i in range(2)]
    pods.append(("near-0", "near", {"cpu": 500.0, "memory": GIB}, 0,
                 {"affinity": {"pod_affinity": [({"app": "web"}, "zone")]}}))
    pods.append(("apart-0", "apart", {"cpu": 500.0, "memory": GIB}, 0,
                 {"affinity": {"pod_anti_affinity": [({"app": "web"},
                                                      "kubernetes.io/hostname")]}}))
    pods += [(f"bulk-{i}", "bulk", {"cpu": 1500.0, "memory": 2 * GIB}, 1) for i in range(6)]
    return {"nodes": nodes, "groups": groups, "pods": pods}


SPECS = {"mixed": mixed_spec, "spill": spill_spec, "config1": config1_spec,
         "static": static_spec, "selector-bound": selector_bound_spec,
         "predicates": predicates_spec, "dynamic": dynamic_spec}


def build_twin(pkg: str, spec: dict):
    """The cluster ``spec`` in package ``pkg`` ("scheduler_tpu" or
    "scheduler_tpu_torch"), objects and timestamps identical
    (``chip_smoke.spec_cluster``, which documents the spec format)."""
    return spec_cluster(spec, pkg)


def synthetic_twin(pkg: str, n_nodes: int, n_pods: int, tasks_per_job: int, queues: int = 1):
    """The flagship's synthetic cluster; with ``queues`` > 1, queues q0, q1,
    ... of weights 1, 2, ... (``bench.py``'s multi-queue flagship)."""
    harness = importlib.import_module(f"{pkg}.harness")
    names = tuple(f"q{i}" for i in range(queues)) if queues > 1 else ("default",)
    return harness.make_synthetic_cluster(
        n_nodes, n_pods, tasks_per_job=tasks_per_job, queues=names,
        queue_weights={q: i + 1 for i, q in enumerate(names)}).cache


def _scenario_ladder():
    path = Path(__file__).resolve().parent.parent / "scripts" / "scenario_ladder.py"
    spec = importlib.util.spec_from_file_location("scenario_ladder", path)
    ladder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ladder)
    return ladder


def gpu_topology_twin(pkg: str, n_nodes: int, n_gangs: int):
    """BASELINE config 5 at ``n_nodes`` x ``n_gangs`` gangs of 8: the JAX
    package's cluster is built by ``scripts/scenario_ladder.py`` itself, the
    port's by its copy, ``harness.make_gpu_topology_cluster``."""
    if pkg == "scheduler_tpu_torch":
        from scheduler_tpu_torch.harness import make_gpu_topology_cluster

        return make_gpu_topology_cluster(n_nodes, n_gangs).cache
    build, _ = _scenario_ladder()._s5_build_churn(n_nodes, n_gangs, 8, {"jobs": [], "gen": 0})
    return build()


def kubemark_twin(pkg: str, n_nodes: int, n_pods: int):
    """BASELINE config 2 at ``n_nodes`` x ``n_pods``: the JAX package's
    cluster is built by ``scripts/scenario_ladder.py`` itself, the port's by
    its own copy, ``harness.make_kubemark_density_cluster``.  Both pin each
    shadow PodGroup's creation time to its pod's, so the two builds order
    their jobs alike."""
    from scheduler_tpu_torch.harness import synthetic

    if pkg == "scheduler_tpu_torch":
        return synthetic.make_kubemark_density_cluster(n_nodes, n_pods).cache
    build, _ = _scenario_ladder()._s2_build_churn(n_nodes, n_pods, {"pods": [], "gen": 0})
    cache = build()
    synthetic.pin_shadow_timestamps(cache)
    return cache


def twin_cache(pkg: str, fixture: str):
    if fixture.startswith("synthetic"):
        return synthetic_twin(pkg, 64, 600, 10)
    if fixture == "kubemark":
        return kubemark_twin(pkg, 64, 600)
    return build_twin(pkg, SPECS[fixture]())


# -- running both kernels -------------------------------------------------------------

def jax_engine(monkeypatch, fixture, conf, cohort):
    monkeypatch.setenv("SCHEDULER_TPU_COHORT", str(cohort))
    ssn = jax_open(twin_cache("scheduler_tpu", fixture), jax_conf(conf).tiers)
    engine = JaxFused(ssn, jax_candidates(ssn))
    assert engine.use_mega, "the JAX engine must stage its mega kernel"
    return engine


def run_both(engine, **overrides):
    """JAX ``mega_allocate`` (interpret mode) and the port's, on the same
    staged operands and static arguments."""
    kw = dict(engine._mega_kw, **overrides)
    codes_j, stats_j = jax_mega(*engine._mega_args, **kw)
    ops = {name: np.asarray(a) for name, a in zip(mk.OPERAND_NAMES, engine._mega_args)}
    args, torch_kw = mega_operands_from_numpy(ops, kw, "cpu")
    codes_t, stats_t = mk.mega_allocate(*args, n_queues=len(engine.queue_uids), **torch_kw)
    return (np.asarray(codes_j), np.asarray(stats_j)), (codes_t.numpy(), stats_t.numpy())


CASES = [
    # (fixture, conf, kernel-argument overrides)
    ("mixed", FLAGSHIP_CONF, {}),
    ("spill", FLAGSHIP_CONF, {}),
    ("synthetic", FLAGSHIP_CONF, {}),
    ("spill", SCORE_BOUND_CONF, {}),
    ("mixed", FLAGSHIP_CONF, {"enforce_pod_count": True}),
    # Static-row mode (predicates + nodeorder).
    ("static", PREDICATES_CONF, {}),
    ("selector-bound", PREDICATES_CONF, {}),
    ("kubemark", CONFIG2_CONF, {}),
    ("predicates", PRESSURE_CONF, {}),
]
CASE_IDS = ["mixed", "spill", "synthetic-64x600", "score-bound", "pod-count",
            "static", "static-score-bound", "config2-64x600", "static-predicates"]
STATIC_CONFS = (PREDICATES_CONF, CONFIG2_CONF, PRESSURE_CONF)

# The conf each fixture's engine is staged under.
FIXTURE_CONF = {"mixed": FLAGSHIP_CONF, "spill": FLAGSHIP_CONF, "synthetic": FLAGSHIP_CONF,
                "static": PREDICATES_CONF, "selector-bound": PREDICATES_CONF,
                "kubemark": CONFIG2_CONF, "predicates": PRESSURE_CONF}


@pytest.mark.parametrize("cohort", [1, 4])
@pytest.mark.parametrize("fixture,conf,overrides", CASES, ids=CASE_IDS)
def test_reference_matches_jax_mega_allocate(monkeypatch, fixture, conf, overrides, cohort):
    engine = jax_engine(monkeypatch, fixture, conf, cohort)
    kw = engine._mega_kw
    assert not (kw["has_releasing"] or kw["multi_queue"])
    assert kw["use_static"] == engine.use_static == (conf in STATIC_CONFS)
    if conf in (SCORE_BOUND_CONF, CONFIG2_CONF) or fixture == "selector-bound":
        # nodeorder's weights turn the top-2 score bound on where runs batch.
        assert kw["score_bound"] and engine.batch_runs
    if fixture == "kubemark":
        # Config 2: the pod-count gate and cross-job batching of shadow jobs.
        assert kw["enforce_pod_count"] and kw["cross_batch"]
    if fixture == "spill":
        # Cohort chunks engage only where a cohort spills across nodes.
        assert engine.cohort_effective == cohort
    (codes_j, stats_j), (codes_t, stats_t) = run_both(engine, **overrides)
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(stats_t, stats_j)
    assert int((codes_t >= 0).sum()) > 0
    if fixture == "spill" and cohort == 4:
        assert stats_t[mk.STATS.COHORT_STEPS] > 0 and stats_t[mk.STATS.CHUNK_PLACED] > 0


def test_pod_count_gate_binds():
    """The pod-count case is not vacuous: with the gate on, the 9-pod nodes
    of the mixed fixture turn placements away that fit by resources."""
    ssn = jax_open(twin_cache("scheduler_tpu", "mixed"), jax_conf(FLAGSHIP_CONF).tiers)
    engine = JaxFused(ssn, jax_candidates(ssn))
    ops = {name: np.asarray(a) for name, a in zip(mk.OPERAND_NAMES, engine._mega_args)}
    ops["plim"] = np.minimum(ops["plim"], 2.0).astype(np.float32)
    args, kw = mega_operands_from_numpy(ops, engine._mega_kw, "cpu")
    free, _ = mk.mega_allocate(*args, **kw)
    gated, _ = mk.mega_allocate(*args, **dict(kw, enforce_pod_count=True))
    assert int((gated >= 0).sum()) < int((free >= 0).sum())
    counts = np.bincount(gated[gated >= 0].numpy(), minlength=8)
    assert counts.max() <= 2


@pytest.mark.parametrize("cohort", [1, 4])
@pytest.mark.parametrize("fixture", sorted(FIXTURE_CONF))
def test_port_stages_the_jax_operands(monkeypatch, fixture, cohort):
    """The port's FusedAllocator, built from the same cluster, stages the
    same 26 operands (bit for bit) and static arguments as the JAX one at
    ``cohort`` chunks.  The port's chunk count follows its device (1 on the
    CPU, 4 on CUDA), so the cohort argument is held apart: the port's spill
    estimate must make the JAX engine's choice at that count.  The static
    fixtures stage ``msig``/``smask``/``sscore`` and the run lengths that
    the static rows cut, although the JAX engine also compresses its static
    tensors to signature classes and the port does not."""
    conf = FIXTURE_CONF[fixture]
    engine = jax_engine(monkeypatch, fixture, conf, cohort)
    ssn = torch_open(twin_cache("scheduler_tpu_torch", fixture),
                     torch_conf(conf).tiers, device="cpu")
    port = TorchFused(ssn, torch_candidates(ssn), device="cpu")
    assert port.use_static == engine.use_static == (conf in STATIC_CONFS)
    if fixture == "kubemark":
        assert engine.sig_compress and engine._mega_kw["use_static"]
    assert port.use_mega and port.cohort_effective == 1
    assert port.cohort_spill == engine.cohort_spill
    spills = port.batch_runs and port.cohort_spill
    assert engine._mega_kw["cohort"] == (cohort if spills else 1)
    assert fused_mod._cohort_chunks(torch.device("cuda")) == 4
    for name, mine, theirs in zip(mk.OPERAND_NAMES, port._mega_args, engine._mega_args):
        theirs = np.asarray(theirs)
        assert mine.dtype == torch.from_numpy(theirs.copy()).dtype, name
        np.testing.assert_array_equal(mine.numpy(), theirs, err_msg=name)
    for key, value in port._mega_kw.items():
        if key != "cohort":
            assert engine._mega_kw[key] == value, key
    # Jobs by their pods' names (a shadow PodGroup's uid holds a pod uid, a
    # process-wide counter).
    def job_keys(jobs):
        return [sorted(t.name for t in j.tasks.values()) for j in jobs]

    assert job_keys(port.jobs) == job_keys(engine.jobs)


def test_wrapper_runs_plain_version_on_cpu_and_rejects_unported_modes(monkeypatch):
    engine = jax_engine(monkeypatch, "mixed", FLAGSHIP_CONF, 1)
    ops = {name: np.asarray(a) for name, a in zip(mk.OPERAND_NAMES, engine._mega_args)}
    args, kw = mega_operands_from_numpy(ops, engine._mega_kw, "cpu")
    before = mk.launches
    codes, stats = mk.mega_allocate(*args, **kw)
    ref_codes, ref_stats = mk.mega_allocate_reference(*args, **kw)
    assert torch.equal(codes, ref_codes) and torch.equal(stats, ref_stats)
    assert mk.launches == before, "the CPU path launches no kernel"
    # Releasing capacity is a ported mode: on CPU tensors the plain version
    # runs it (tests/test_torch_releasing.py holds it to the JAX kernel).
    rel_kw = dict(kw, has_releasing=True)
    codes, stats = mk.mega_allocate(*args, **rel_kw)
    ref_codes, ref_stats = mk.mega_allocate_reference(*args, **rel_kw)
    assert torch.equal(codes, ref_codes) and torch.equal(stats, ref_stats)
    assert mk.launches == before
    # Mesh mode (ops/mesh.py): the same launch with every operand whole on
    # the mesh's first device; anything but a NodeMesh, or operands
    # elsewhere, raises.
    from scheduler_tpu_torch.ops.mesh import NodeMesh

    plain = mk.mega_allocate_reference(*args, **kw)
    got = mk.mega_allocate(*args, **dict(kw, mesh=NodeMesh(["cpu"] * 4, {"nodes": 4})))
    assert all(torch.equal(g, w) for g, w in zip(got, plain))
    with pytest.raises(TypeError, match="NodeMesh"):
        mk.mega_allocate(*args, **dict(kw, mesh=object()))
    with pytest.raises(ValueError, match="first device"):
        mk.mega_allocate(*args, **dict(kw, mesh=NodeMesh(["meta"] * 2, {"nodes": 2})))
    # The qfair ladder refines multi-queue mode's delta chain: not cursor mode.
    with pytest.raises(ValueError, match="qfair ladder"):
        mk.mega_allocate(*args, **dict(kw, qfair_ladder=True))


# -- synthetic operands and the launch plan -----------------------------------------

# chip_smoke.MEGA_SYNTHETIC's cases at CPU size, with exact score terms: all
# three score terms with the pod-count gate at r_dim 8, equal scores on
# nodes far apart (ties), the score bound's second-best far from the winner,
# a chunk where no node fits, and static rows with cross-job batches.
SYNTHETIC_CPU = {
    "r8-all-terms-pods": dict(seed=1, nb=256, r_dim=8, n_jobs=30, n_nodes=200,
                              weights=(1.0, 1.0, 1.0), score_bound=True,
                              enforce_pod_count=True, cohort=4),
    "ties": dict(seed=4, nb=256, r_dim=2, n_jobs=20, alike=True, gated=(250, 130, 40, 7)),
    "second-best": dict(seed=5, nb=256, r_dim=2, n_jobs=20, alike=True, gated=(3, 200),
                        weights=(0.0, 1.0, 0.0), score_bound=True, cohort=4),
    "infeasible-chunk": dict(seed=6, nb=256, r_dim=3, n_jobs=20, infeasible_job=True,
                             weights=(1.0, 0.0, 1.0), score_bound=True, cohort=4),
    "static-cross-job": dict(seed=7, nb=256, r_dim=2, n_jobs=40, max_tasks=1,
                             weights=(0.0, 1.0, 1.0), score_bound=True,
                             enforce_pod_count=True, use_static=True, cohort=4),
}


@pytest.mark.parametrize("cohort", [1, 4])
@pytest.mark.parametrize("case", sorted(SYNTHETIC_CPU))
def test_reference_matches_jax_on_synthetic_operands(case, cohort):
    """``chip_smoke.mega_operands`` (the operands of the card's synthetic
    K2 cases) through the JAX kernel in interpret mode and the port: codes
    and stats bitwise equal (tolerance: none)."""
    spec = dict(SYNTHETIC_CPU[case], cohort=cohort)
    ops, kw = smoke.mega_operands(exact=True, **spec)
    codes_j, stats_j = jax_mega(*(ops[name] for name in mk.OPERAND_NAMES), interpret=True, **kw)
    args, torch_kw = mega_operands_from_numpy(ops, kw, "cpu")
    codes_t, stats_t = mk.mega_allocate(*args, **torch_kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(stats_t.numpy(), np.asarray(stats_j))
    placed = codes_t[codes_t >= 0]
    assert placed.numel() > 0
    if case == "infeasible-chunk":
        assert int((codes_t == mk.FAILED).sum()) > 0
    if spec.get("gated"):
        assert set(placed.tolist()) <= set(spec["gated"])
        if case == "ties":
            assert int(placed[0]) == min(spec["gated"]), "equal scores: the lowest index wins"


# Every shape the mega gate admits, on a grid: node buckets up to 32,768,
# job lanes past what any CTA holds, request tables up to 4,096 signatures,
# static rows up to the gate's s_pad x n x 8 <= 4 MiB.
PLAN_NB = (128, 1024, 4096, 10_112, 16_384, 20_480, 32_768)
PLAN_J_PAD = (256, 1152, 5248, 8320, 12_160, 16_384, 65_536)
PLAN_S_PAD = (128, 1024, 4096)


@pytest.mark.parametrize("r_dim", range(1, 9))
def test_mega_plan_fits_every_admitted_shape(r_dim):
    budget = mk.SMEM_LIMIT - mk._STATIC_SMEM
    for nb in PLAN_NB:
        max_rows = (4 * 1024 * 1024) // (nb * 8)
        statics = [(False, 8)] + [(True, rows) for rows in (8, 64, max_rows)
                                  if 8 <= rows <= max_rows and rows % 8 == 0]
        for j_pad in PLAN_J_PAD:
            for s_pad in PLAN_S_PAD:
                for use_static, rows in statics:
                    assert mk.mega_supported(
                        has_releasing=False, use_static=use_static, score_bound=True,
                        cursor_mode=True, r_dim=r_dim, n=nb, n_sigs=s_pad,
                        comparators=("priority", "gang", "drf"),
                        n_static_sigs=rows if use_static else 0)
                    plan = mk.mega_plan(nb, r_dim, j_pad, s_pad, rows, use_static)
                    shape = (nb, r_dim, j_pad, s_pad, rows, use_static)
                    assert plan.ctas in (8, 16), shape
                    assert plan.threads == mk.THREADS
                    assert plan.smem_bytes + mk._STATIC_SMEM <= mk.SMEM_LIMIT, shape
                    assert plan.slice * plan.ctas >= nb and plan.slice % 4 == 0
                    node = mk.node_slice_bytes(plan.slice, r_dim)
                    # The regions, in the plan's order: on chip exactly where
                    # they still fit, disjoint, inside the dynamic allocation.
                    used = node
                    for off, size in (
                        (plan.off_js, mk.job_ledger_bytes(j_pad, r_dim)),
                        (plan.off_sig, 2 * r_dim * s_pad * 4),
                        (plan.off_job, 6 * j_pad * 4),
                        (plan.off_static, 2 * rows * plan.slice * 4 if use_static else None),
                    ):
                        fits = size is not None and used + size <= budget
                        assert (off is not None) == fits, shape
                        if fits:
                            assert off == used and off % 16 == 0
                            used = -(-(used + size) // 16) * 16
                    assert plan.smem_bytes == used
                    # C = 16 only where 8 CTAs could not hold the node slice
                    # with the job ledger and 16 can.
                    eight = mk.node_slice_bytes(-(-nb // 32) * 4, r_dim)
                    job = mk.job_ledger_bytes(j_pad, r_dim)
                    if plan.ctas == 16:
                        assert eight > budget or (eight + job > budget and not plan.job_ledger_in_global)
                    else:
                        assert eight + job <= budget or plan.job_ledger_in_global
                    for n_cover in {1, nb // 3 + 1, nb}:
                        slices = mk.node_slices(n_cover, plan.ctas)
                        assert sum(count for _, count in slices) == n_cover
                        assert all(count <= plan.slice for _, count in slices)
                        starts = [base for base, count in slices if count]
                        assert starts == sorted(starts) and starts[0] == 0


def test_mega_plan_at_the_main_paths():
    """The plans of the two main paths, the widest node ledger and the
    many-jobs case that keeps its job ledger in global memory."""
    flagship = mk.mega_plan(16_384, 2, 1152, 128, 8, False)
    assert flagship.ctas == 8 and flagship.slice == 2048
    assert flagship.summary()["on_chip"] == ["job_ledger", "sig_req", "job_operands"]
    config2 = mk.mega_plan(1024, 2, 8320, 128, 8, True)
    assert config2.ctas == 8 and not config2.job_ledger_in_global
    assert config2.off_static is not None and config2.off_job is None
    widest = mk.mega_plan(32_768, 8, 1152, 128, 8, False)
    assert widest.ctas == 16 and not widest.job_ledger_in_global
    assert mk.mega_plan(64, 2, 12_160, 128, 8, False).job_ledger_in_global
    assert not mk.mega_plan(64, 2, 8320, 128, 8, False).job_ledger_in_global


@pytest.mark.parametrize("seed", range(4))
def test_node_slices_cover_the_gated_prefix(seed):
    """The partition covers [0, last gated node + 1) in equal contiguous
    shares; with no node gated it covers node 0 alone."""
    rng = np.random.default_rng(seed)
    nb = int(rng.choice([128, 1024, 16_384]))
    gate = rng.random(nb) < 0.3
    gate[int(rng.integers(0, nb)):] = False
    if seed == 3:
        gate[:] = False
    n_cover = mk.covered_nodes(torch.from_numpy(gate))
    last = int(np.flatnonzero(gate).max()) if gate.any() else -1
    assert n_cover == max(1, last + 1)
    for ctas in (8, 16):
        slices = mk.node_slices(n_cover, ctas)
        covered = np.concatenate([np.arange(base, base + count) for base, count in slices])
        np.testing.assert_array_equal(covered, np.arange(n_cover))
        counts = [count for _, count in slices if count]
        assert max(counts) - min(counts[:-1] or counts) == 0
