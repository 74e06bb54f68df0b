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


def synthetic_twin(pkg: str, n_nodes: int, n_pods: int, tasks_per_job: int):
    harness = importlib.import_module(f"{pkg}.harness")
    return harness.make_synthetic_cluster(n_nodes, n_pods, tasks_per_job=tasks_per_job).cache


def kubemark_twin(pkg: str, n_nodes: int, n_pods: int):
    """BASELINE config 2 at ``n_nodes`` x ``n_pods``: the JAX package's
    cluster is built by ``scripts/scenario_ladder.py`` itself, the port's by
    its own copy, ``harness.make_kubemark_density_cluster``.  Both pin each
    shadow PodGroup's creation time to its pod's, so the two builds order
    their jobs alike."""
    from scheduler_tpu_torch.harness import synthetic

    if pkg == "scheduler_tpu_torch":
        return synthetic.make_kubemark_density_cluster(n_nodes, n_pods).cache
    path = Path(__file__).resolve().parent.parent / "scripts" / "scenario_ladder.py"
    spec = importlib.util.spec_from_file_location("scenario_ladder", path)
    ladder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ladder)
    build, _ = ladder._s2_build_churn(n_nodes, n_pods, {"pods": [], "gen": 0})
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
    codes_t, stats_t = mk.mega_allocate(*args, **torch_kw)
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
    for mode in ("has_releasing", "multi_queue", "qfair_ladder"):
        with pytest.raises(NotImplementedError):
            mk.mega_allocate(*args, **dict(kw, **{mode: True}))
    with pytest.raises(NotImplementedError):
        mk.mega_allocate(*args, **dict(kw, mesh=object()))
