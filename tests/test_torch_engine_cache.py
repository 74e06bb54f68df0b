"""The port's engine cache across cycles against the JAX package's, on the CPU.

The trajectory protocol of ``tests/test_engine_cache_parity.py``: one
cluster runs a fixed sequence of cycles, each after a mutation (evictions,
node add / remove / resize, a new job, a vocabulary that grows), once with
the engine cache on and once with it off.  The same sequence runs in both
packages on clusters built from the same objects and timestamps.  Cycle by
cycle the port's cached run must equal its cold run (binds and task
statuses, keyed by name) and the JAX package's cached run (binds, statuses,
the ``engine_cache`` outcome and the ``dirty`` refresh evidence).

The JAX side runs its default flavor (proportion's device water-fill),
which needs ``jax.experimental.enable_x64``; this jax has ``jax.enable_x64``
instead, which an autouse fixture of this module puts in its place.
"""

import importlib

import jax
import jax.experimental
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import FLAGSHIP_CONF, template_cluster

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
TS0 = 1_700_000_000.0
GIB = 1024.0**3

CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: proportion
  - name: predicates
  - name: binpack
"""

# Each package's flag that turns the engine cache off.
CACHE_FLAG = {"scheduler_tpu": "SCHEDULER_TPU_ENGINE_CACHE",
              "scheduler_tpu_torch": "SCHEDULER_TORCH_ENGINE_CACHE"}


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.apis.objects"),
            importlib.import_module(f"{pkg}.cache.cache"),
            importlib.import_module(f"{pkg}.api.vocab"))


class _Clock:
    """Creation timestamps in build order, the same in both packages."""

    def __init__(self):
        self.k = 0

    def __call__(self, obj):
        self.k += 1
        obj.creation_timestamp = TS0 + self.k * 1e-6
        return obj


def _node(objects, name, alloc):
    return objects.NodeSpec(name=name, allocatable=dict(alloc, pods=110))


def _pod(objects, clock, name, req, group, node="", phase="Pending"):
    return clock(objects.PodSpec(
        name=name, namespace="default", containers=[dict(req)], node_name=node, phase=phase,
        annotations={objects.GROUP_NAME_ANNOTATION: group}))


def _group(objects, clock, name, queue, min_member, phase="Inqueue"):
    pg = objects.PodGroup(name=name, namespace="default", queue=queue, min_member=min_member)
    pg.status.phase = phase
    return clock(pg)


def build_cluster(pkg, n_queues):
    """``tests/test_engine_cache_parity.py::build_cluster`` in package
    ``pkg``: 4 nodes, two running jobs to churn, a gang that never fits (a
    stable layout: the hit path) and a gang the first cycle places."""
    objects, cache_mod, vocab = _mods(pkg)
    clock = _Clock()
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    cache._clock = clock
    queues = [f"q{i}" for i in range(n_queues)]
    for i, q in enumerate(queues):
        cache.add_queue(clock(objects.Queue(name=q, weight=i + 1)))
    for i in range(4):
        cache.add_node(_node(objects, f"n{i:02d}", {"cpu": 4000, "memory": 8 * GIB}))
    for j in range(2):
        g = f"run{j}"
        cache.add_pod_group(_group(objects, clock, g, queues[j % n_queues], 1, "Running"))
        for t in range(2):
            cache.add_pod(_pod(objects, clock, f"{g}-{t}", {"cpu": 1000, "memory": GIB}, g,
                               node=f"n{(j * 2 + t) % 4:02d}", phase="Running"))
    cache.add_pod_group(_group(objects, clock, "stuck", queues[0], 1))
    cache.add_pod(_pod(objects, clock, "stuck-0", {"cpu": 64000, "memory": 256 * GIB}, "stuck"))
    cache.add_pod_group(_group(objects, clock, "gang0", queues[-1], 2))
    for t in range(2):
        cache.add_pod(_pod(objects, clock, f"gang0-{t}", {"cpu": 500, "memory": GIB}, "gang0"))
    return cache


# -- the mutations of tests/test_engine_cache_parity.py, keyed on names --------------

def evict_one_running(pkg, cache):
    types = importlib.import_module(f"{pkg}.api.types")
    tasks = [t for job in cache.jobs.values() for t in job.tasks.values()
             if t.node_name and t.status == types.TaskStatus.RUNNING]
    if tasks:
        cache.evict(min(tasks, key=lambda t: t.name), "parity churn")


def add_node(pkg, cache):
    cache.add_node(_node(_mods(pkg)[0], "nz-added", {"cpu": 4000, "memory": 8 * GIB}))


def remove_node(pkg, cache):
    cache.delete_node(_node(_mods(pkg)[0], "nz-added", {}))


def grow_node_resources(pkg, cache):
    cache.update_node(_node(_mods(pkg)[0], "n00", {"cpu": 8000, "memory": 16 * GIB}))


def add_job(pkg, cache):
    objects = _mods(pkg)[0]
    q = sorted(cache.queues)[0]
    cache.add_pod_group(_group(objects, cache._clock, "late", q, 1))
    cache.add_pod(_pod(objects, cache._clock, "late-0", {"cpu": 500, "memory": GIB}, "late"))


def grow_vocab(pkg, cache):
    objects = _mods(pkg)[0]
    q = sorted(cache.queues)[0]
    cache.add_node(_node(objects, "ngpu", {"cpu": 4000, "memory": 8 * GIB,
                                           "nvidia.com/gpu": 2}))
    cache.add_pod_group(_group(objects, cache._clock, "gpujob", q, 1))
    cache.add_pod(_pod(objects, cache._clock, "gpujob-0",
                       {"cpu": 500, "memory": GIB, "nvidia.com/gpu": 1}, "gpujob"))


MUTATIONS = [None, None, None, evict_one_running, None, None, add_node, grow_node_resources,
             add_job, remove_node, grow_vocab, None, None]


def run_trajectory(pkg, n_queues, cached, monkeypatch):
    """Per cycle: (binds, statuses by task name, engine-cache outcome, the
    ``dirty`` evidence), and the engine cache's counters."""
    conf_mod = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    phases = importlib.import_module(f"{pkg}.utils.phases")
    engine_cache = importlib.import_module(f"{pkg}.ops.engine_cache")
    monkeypatch.setenv(CACHE_FLAG[pkg], "1" if cached else "0")
    if pkg == "scheduler_tpu":
        monkeypatch.setenv("SCHEDULER_TPU_DEVICE", "1")
        monkeypatch.setenv("SCHEDULER_TPU_FUSED", "1")
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    engine_cache.clear()
    engine_cache.reset_counters()
    cache = build_cluster(pkg, n_queues)
    conf = conf_mod.parse_scheduler_conf(CONF)
    out = []
    for mutate in MUTATIONS:
        if mutate is not None:
            mutate(pkg, cache)
        phases.begin()
        ssn = framework.open_session(cache, conf.tiers, **kw)
        framework.get_action("allocate").execute(ssn)
        statuses = {t.name: t.status.name for job in ssn.jobs.values()
                    for t in job.tasks.values()}
        framework.close_session(ssn)
        notes = phases.take_notes()
        phases.end()
        out.append((dict(cache.binder.binds), statuses, notes.get("engine_cache"),
                    notes.get("dirty")))
    counters = engine_cache.reset_counters()
    engine_cache.clear()
    return out, counters


@pytest.mark.parametrize("n_queues", [1, 2])
def test_engine_cache_trajectory_matches_jax(n_queues, monkeypatch):
    port, port_counts = run_trajectory("scheduler_tpu_torch", n_queues, True, monkeypatch)
    cold, _ = run_trajectory("scheduler_tpu_torch", n_queues, False, monkeypatch)
    ref, _ = run_trajectory("scheduler_tpu", n_queues, True, monkeypatch)
    assert len(port) == len(cold) == len(ref) == len(MUTATIONS)
    for i, (got, want, jax_got) in enumerate(zip(port, cold, ref)):
        assert got[:2] == want[:2], f"cycle {i}: the cached run differs from the cold run"
        assert got == jax_got, f"cycle {i}: the port differs from the JAX package"
    outcomes = [c[2] for c in port]
    assert "hit" in outcomes and any(c[3] and c[3]["mode"] == "sparse" for c in port)
    assert port_counts["hits"] >= 2, port_counts
    assert port_counts["misses"] >= 2, port_counts
    assert port_counts["rebuilds"] >= 1, port_counts


def test_step_engine_hit_places_as_cold(monkeypatch):
    """A ``step``-engine session (config3_templates' shape, 4,200 single-pod
    jobs of distinct requests: the mega gate closes) through the steady
    protocol: the warm build misses, the measured cycle hits and binds as
    a cold cycle on a twin cluster does."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.harness.measure import steady_cycle_phases, timed_cycle_phases
    from scheduler_tpu_torch.ops import engine_cache

    conf = parse_scheduler_conf(FLAGSHIP_CONF)
    engine_cache.clear()
    warm = template_cluster(16, 4200, 1)
    _, rec = steady_cycle_phases(warm, conf, ("allocate",), device="cpu")
    assert rec["notes"]["engine_cache"] == "hit"
    assert rec["notes"]["cohort"]["engine"] == "step"
    assert rec["overlap_host"] == 0.0  # the loop runs before the rebind
    engine_cache.clear()
    monkeypatch.setenv("SCHEDULER_TORCH_ENGINE_CACHE", "0")
    cold = template_cluster(16, 4200, 1)
    _, rec_cold = timed_cycle_phases(cold, conf, ("allocate",), device="cpu")
    assert rec_cold["notes"]["engine_cache"] == "off"
    assert warm.binder.binds and dict(warm.binder.binds) == dict(cold.binder.binds)


def test_dirty_marks():
    """The cache's dirty-set marks: a mutation marks its node and job, the
    snapshot carries the epoch, and an overflowing map answers unknown."""
    cache = build_cluster("scheduler_tpu_torch", 1)
    epoch = cache.snapshot().dirty_epoch
    assert epoch == cache._dirty_epoch > 0
    assert cache.dirty_nodes_since(epoch) == set()
    evict_one_running("scheduler_tpu_torch", cache)
    assert cache.dirty_nodes_since(epoch) == {"n00"}
    assert cache.dirty_counts_since(epoch) == {"nodes": 1, "jobs": 1, "queues": 0}
    cache._mark_dirty("node", (f"x{i}" for i in range(cache._DIRTY_CAP + 1)))
    assert cache.dirty_nodes_since(epoch) is None
    assert cache.dirty_counts_since(epoch)["nodes"] == -1


def test_ladder_hit_equals_a_cold_engine():
    """A hit on a qfair-ladder session after completions moved the queue
    rows: the resident engine re-solves proportion, rebuilds the ladder's
    tables and K2's queue lanes, and its codes, stats and tables equal those
    of an engine built cold on the same session."""
    import numpy as np

    from chip_smoke import MULTIQ_CONF
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, get_action, open_session
    from scheduler_tpu_torch.harness import make_mq_ladder_cluster
    from scheduler_tpu_torch.ops import engine_cache
    from scheduler_tpu_torch.ops.fused import FusedAllocator
    from scheduler_tpu_torch.utils import phases

    cache = make_mq_ladder_cluster(16, 1200, 6, 6).cache
    tiers = parse_scheduler_conf(MULTIQ_CONF).tiers
    engine_cache.clear()
    for _ in range(2):  # miss, then rebuild: what fits is placed
        ssn = open_session(cache, tiers, device="cpu")
        get_action("allocate").execute(ssn)
        close_session(ssn)
    bound = sorted((t for j in cache.jobs.values() for t in j.tasks.values() if t.node_name),
                   key=lambda t: t.name)
    for task in bound[:3]:
        cache.delete_pod(task.pod)
    phases.begin()
    ssn = open_session(cache, tiers, device="cpu")
    cands = collect_candidates(ssn)
    engine, status = engine_cache.get_engine(ssn, cands, eager_dispatch=True)
    dirty = phases.take_notes()["dirty"]
    phases.end()
    assert status == "hit" and dirty["mode"] == "sparse" and dirty["rows_scattered"] > 0
    assert engine.use_mega and engine._mega_kw["qfair_ladder"]
    codes = engine.readback().copy()
    cold = FusedAllocator(ssn, cands, device="cpu")
    np.testing.assert_array_equal(codes, cold.readback())
    np.testing.assert_array_equal(engine._stats_raw, cold._stats_raw)
    for got, want in zip(engine._ladder_host, cold._ladder_host):
        np.testing.assert_array_equal(got, want)
    assert (codes >= 0).sum() == 3  # the freed slots are taken again
    close_session(ssn)
    engine_cache.clear()


def test_static_mask_memo_builds_only_missing_signatures(monkeypatch):
    """The predicates plugin's signature rows persist in the cache's
    ``static_mask_cache``: a second build on the same cluster computes no
    row and stages the same static rows; a new signature computes one row;
    a node event (a new node generation) starts the memo over."""
    from chip_smoke import CONFIG2_CONF, engine_for
    from scheduler_tpu_torch.apis.objects import NodeSpec, PodSpec
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster
    from scheduler_tpu_torch.plugins.predicates import PredicatesPlugin

    computed = []
    compute = PredicatesPlugin._compute_sig_rows

    def counting(st, sel, unk, tol, pressure_ok, device):
        computed.append(sel.shape[0])
        return compute(st, sel, unk, tol, pressure_ok, device)

    monkeypatch.setattr(PredicatesPlugin, "_compute_sig_rows", staticmethod(counting))
    cache = make_kubemark_density_cluster(16, 120).cache
    _, first = engine_for(cache, CONFIG2_CONF, "cpu")
    _, second = engine_for(cache, CONFIG2_CONF, "cpu")
    assert computed == [3]  # zones z0 and z2 and no selector, once
    assert torch.equal(first._mega_args[18], second._mega_args[18])  # smask
    pod = PodSpec(name="odd", namespace="d", scheduler_name="volcano",
                  containers=[{"cpu": 100.0, "memory": 2.0**30}], node_selector={"disk": "ssd"})
    pod.creation_timestamp = 1_700_000_100.0
    cache.add_pod(pod)
    engine_for(cache, CONFIG2_CONF, "cpu")
    assert computed == [3, 1]
    cache.add_node(NodeSpec(name="hollow-99999", labels={"zone": "z0"},
                            allocatable={"cpu": 16000.0, "memory": 64 * 2.0**30, "pods": 110}))
    engine_for(cache, CONFIG2_CONF, "cpu")
    assert computed == [3, 1, 4]
