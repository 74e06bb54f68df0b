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
import random

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
# turn the kernel's top-2 score bound on (JAX side only: the port has no
# nodeorder plugin yet).
SCORE_BOUND_CONF = FLAGSHIP_CONF + """  - name: nodeorder
    arguments:
      nodeaffinity.weight: 0
"""

GIB = 2.0**30
TS0 = 1_700_000_000.0


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


SPECS = {"mixed": mixed_spec, "spill": spill_spec, "config1": config1_spec}


def build_twin(pkg: str, spec: dict):
    """The cluster ``spec`` in package ``pkg`` ("scheduler_tpu" or
    "scheduler_tpu_torch"), objects and timestamps identical."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache_mod = importlib.import_module(f"{pkg}.cache.cache")
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    queue = objects.Queue(name="default", weight=1)
    queue.creation_timestamp = TS0
    cache.add_queue(queue)
    for name, alloc in spec["nodes"]:
        cache.add_node(objects.NodeSpec(name=name, allocatable=dict(alloc)))
    for k, (name, min_member) in enumerate(spec["groups"]):
        pg = objects.PodGroup(name=name, namespace="default", queue="default",
                              min_member=min_member)
        pg.status.phase = "Inqueue"
        pg.creation_timestamp = TS0 + (k + 1) * 1e-6
        cache.add_pod_group(pg)
    for k, (name, group, req, prio) in enumerate(spec["pods"]):
        pod = objects.PodSpec(
            name=name, namespace="default", containers=[dict(req)], phase="Pending",
            priority=prio, annotations={objects.GROUP_NAME_ANNOTATION: group},
        )
        pod.creation_timestamp = TS0 + 1.0 + k * 1e-6
        cache.add_pod(pod)
    return cache


def synthetic_twin(pkg: str, n_nodes: int, n_pods: int, tasks_per_job: int):
    harness = importlib.import_module(f"{pkg}.harness")
    return harness.make_synthetic_cluster(n_nodes, n_pods, tasks_per_job=tasks_per_job).cache


def twin_cache(pkg: str, fixture: str):
    if fixture.startswith("synthetic"):
        return synthetic_twin(pkg, 64, 600, 10)
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
]
CASE_IDS = ["mixed", "spill", "synthetic-64x600", "score-bound", "pod-count"]


@pytest.mark.parametrize("cohort", [1, 4])
@pytest.mark.parametrize("fixture,conf,overrides", CASES, ids=CASE_IDS)
def test_reference_matches_jax_mega_allocate(monkeypatch, fixture, conf, overrides, cohort):
    engine = jax_engine(monkeypatch, fixture, conf, cohort)
    kw = engine._mega_kw
    assert not (kw["has_releasing"] or kw["use_static"] or kw["multi_queue"])
    if conf is SCORE_BOUND_CONF:
        assert kw["score_bound"] and engine.batch_runs
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
@pytest.mark.parametrize("fixture", ["mixed", "spill", "synthetic"])
def test_port_stages_the_jax_operands(monkeypatch, fixture, cohort):
    """The port's FusedAllocator, built from the same cluster, stages the
    same 26 operands (bit for bit) and static arguments as the JAX one at
    ``cohort`` chunks.  The port's chunk count follows its device (1 on the
    CPU, 4 on CUDA), so the cohort argument is held apart: the port's spill
    estimate must make the JAX engine's choice at that count."""
    engine = jax_engine(monkeypatch, fixture, FLAGSHIP_CONF, cohort)
    ssn = torch_open(twin_cache("scheduler_tpu_torch", fixture),
                     torch_conf(FLAGSHIP_CONF).tiers, device="cpu")
    port = TorchFused(ssn, torch_candidates(ssn), device="cpu")
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
    assert [j.uid for j in port.jobs] == [j.uid for j in engine.jobs]


def test_wrapper_runs_plain_version_on_cpu_and_rejects_unported_modes(monkeypatch):
    engine = jax_engine(monkeypatch, "mixed", FLAGSHIP_CONF, 1)
    ops = {name: np.asarray(a) for name, a in zip(mk.OPERAND_NAMES, engine._mega_args)}
    args, kw = mega_operands_from_numpy(ops, engine._mega_kw, "cpu")
    before = mk.launches
    codes, stats = mk.mega_allocate(*args, **kw)
    ref_codes, ref_stats = mk.mega_allocate_reference(*args, **kw)
    assert torch.equal(codes, ref_codes) and torch.equal(stats, ref_stats)
    assert mk.launches == before, "the CPU path launches no kernel"
    for mode in ("has_releasing", "use_static", "multi_queue", "qfair_ladder"):
        with pytest.raises(NotImplementedError):
            mk.mega_allocate(*args, **dict(kw, **{mode: True}))
    with pytest.raises(NotImplementedError):
        mk.mega_allocate(*args, **dict(kw, mesh=object()))
