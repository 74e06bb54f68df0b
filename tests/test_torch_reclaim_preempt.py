"""The port's reclaim and preempt actions against the JAX package, on the CPU.

The same clusters are built in both packages (same objects, same
timestamps) and run through the same actions; the committed evictions (in
commit order, captured at the cache), every task's status and node, and the
binds must be equal (all keyed by name: UIDs are a process-global counter).
The JAX package runs its default host hunt (``SCHEDULER_TPU_EVICT`` unset),
which is the port's hunt.  Fixtures: ``tests/test_evict_parity.py``'s storm
clusters (``chip_smoke.storm_spec``, the same recipe and numbers) under its
preempt, reclaim and full confs, its gang-floor cluster and its mutation
trajectory; ``tests/test_sweep.py``'s sweep and victim-gate clusters, where
the port's memoized sweep and pre-gate must equal the JAX package's
reference per-task sweep (``SCHEDULER_TPU_SWEEP=0``) and ungated hunt
(``SCHEDULER_TPU_VICTIM_GATE=0``); BASELINE config 4 before its reclaim at
2 % (reclaim, then allocate); and ``deploy/scheduler-conf.yaml`` through
``Scheduler.run_once`` on small clusters, on the fused and the device
routes.  The action registry must equal the JAX package's.  The JAX side
runs proportion's device water-fill through ``jax.enable_x64`` put in
place of ``jax.experimental.enable_x64`` by an autouse fixture of this
module.
"""

import copy
import importlib
import itertools
import os

import jax
import jax.experimental
import numpy as np
import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import spec_cluster, storm_spec
from scheduler_tpu_torch.harness.synthetic import pin_shadow_timestamps
from tests.test_torch_megakernel import kubemark_twin

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
TS0 = 1_700_000_000.0
GIB = 1024.0**3
MIB = 1024.0**2

PREEMPT_CONF = """
actions: "preempt"
tiers:
- plugins:
  - name: conformance
  - name: gang
  - name: priority
  - name: drf
  - name: binpack
"""

RECLAIM_CONF = """
actions: "reclaim"
tiers:
- plugins:
  - name: conformance
  - name: gang
  - name: proportion
"""

FULL_CONF = """
actions: "reclaim, preempt"
tiers:
- plugins:
  - name: conformance
  - name: gang
  - name: priority
  - name: drf
  - name: proportion
  - name: binpack
"""

# tests/test_sweep.py's confs.
SWEEP_PREEMPT_CONF = """
actions: "allocate, preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
  - name: predicates
  - name: nodeorder
"""

SWEEP_RECLAIM_CONF = """
actions: "reclaim"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: proportion
  - name: predicates
  - name: nodeorder
"""

TIERED_RECLAIM_CONF = """
actions: "reclaim"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: proportion
"""

# BASELINE config 4 (scripts/scenario_ladder.py scenario 4), then allocate.
CONFIG4_CONF = """
actions: "reclaim, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: proportion
"""


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    for name in ("SCHEDULER_TPU_EVICT", "SCHEDULER_TPU_SWEEP", "SCHEDULER_TPU_VICTIM_GATE",
                 "SCHEDULER_TPU_FUSED_STATIC_LIMIT", "SCHEDULER_TORCH_FUSED_STATIC_LIMIT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def _uids_in_step():
    """Leave both packages' UID counters (process-global) at one value: the
    twin tests of other modules key shadow PodGroups by pod UID, and the
    clusters here are built a different number of times in each package."""
    yield
    import scheduler_tpu.apis.objects as jax_objects
    import scheduler_tpu_torch.apis.objects as torch_objects

    step = max(next(jax_objects._uid_counter), next(torch_objects._uid_counter))
    jax_objects._uid_counter = itertools.count(step)
    torch_objects._uid_counter = itertools.count(step)


class Twin:
    """A cache of package ``pkg`` and its objects, with creation timestamps
    in build order (the same in both packages)."""

    def __init__(self, pkg):
        self.objects = importlib.import_module(f"{pkg}.apis.objects")
        vocab = importlib.import_module(f"{pkg}.api.vocab")
        cache_mod = importlib.import_module(f"{pkg}.cache.cache")
        self.cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
        self.cache.run()
        self.k = 0

    def _stamp(self, obj):
        self.k += 1
        obj.creation_timestamp = TS0 + self.k * 1e-6
        return obj

    def queue(self, name, weight=1):
        self.cache.add_queue(self._stamp(self.objects.Queue(name=name, weight=weight)))

    def node(self, name, cpu, memory, labels=None, pods=110):
        self.cache.add_node(self.objects.NodeSpec(
            name=name, allocatable={"cpu": float(cpu), "memory": float(memory), "pods": pods},
            labels=dict(labels or {})))

    def group(self, name, queue="default", min_member=1, phase="Inqueue",
              priority_class=None):
        pg = self.objects.PodGroup(name=name, namespace="default", queue=queue,
                                   min_member=min_member)
        pg.status.phase = phase
        if priority_class:
            pg.priority_class_name = priority_class
        self.cache.add_pod_group(self._stamp(pg))

    def pod(self, name, group, cpu, memory, node="", phase="Pending", priority=0,
            selector=None, host_ports=()):
        self.cache.add_pod(self._stamp(self.objects.PodSpec(
            name=name, namespace="default", containers=[{"cpu": float(cpu),
                                                         "memory": float(memory)}],
            node_name=node, phase=phase, priority=priority,
            annotations={self.objects.GROUP_NAME_ANNOTATION: group},
            node_selector=dict(selector or {}), host_ports=list(host_ports))))


def run_session(pkg, cache, conf_text, env=()):
    """One session of ``conf_text``'s actions: the committed evictions
    (cache-seam order), the end-of-session task (status, node) pairs, the
    binds, and whether every gang kept its floor (relative to the action's
    start, as ``tests/test_evict_parity.py`` reads it)."""
    conf_mod = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    old = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    evlog = []
    evict, evict_bulk = cache.evict, cache.evict_bulk

    def one(task, reason):
        evlog.append((task.name, reason))
        return evict(task, reason)

    def bulk(tasks, reason):
        out = evict_bulk(tasks, reason)
        evlog.extend((t.name, reason) for t in out)
        return out

    cache.evict, cache.evict_bulk = one, bulk
    try:
        conf = conf_mod.parse_scheduler_conf(conf_text)
        kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
        ssn = framework.open_session(cache, conf.tiers, **kw)
        before = {job.uid: job.ready_task_num() for job in ssn.jobs.values()
                  if job.min_available > 1}
        for name in conf.actions:
            framework.get_action(name).execute(ssn)
        statuses = {t.name: (t.status.name, t.node_name)
                    for job in ssn.jobs.values() for t in job.tasks.values()}
        floors_ok = all(job.ready_task_num() >= min(job.min_available, before[job.uid])
                        for job in ssn.jobs.values() if job.uid in before)
        framework.close_session(ssn)
    finally:
        cache.evict, cache.evict_bulk = evict, evict_bulk
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return tuple(evlog), statuses, dict(cache.binder.binds), floors_ok


def both(build, conf_text, env=()):
    """``build(pkg)``'s cache in each package through ``conf_text``."""
    return {pkg: run_session(pkg, build(pkg), conf_text, env) for pkg in PKGS}


def assert_equal(out):
    jax_out, port = out["scheduler_tpu"], out["scheduler_tpu_torch"]
    assert port[0] == jax_out[0]  # evictions, in commit order
    assert port[1] == jax_out[1]  # statuses and nodes
    assert port[2] == jax_out[2]  # binds
    assert port[3], "gang floor violated"
    return port


# -- tests/test_evict_parity.py's storms ---------------------------------------------

@pytest.mark.parametrize("seed", [7, 42, 1234])
@pytest.mark.parametrize("n_queues", [1, 2])
def test_preempt_matches_jax(seed, n_queues):
    port = assert_equal(both(lambda pkg: spec_cluster(storm_spec(seed, n_queues), pkg),
                             PREEMPT_CONF))
    assert port[0] and all(reason == "preempt" for _, reason in port[0])


@pytest.mark.parametrize("seed", [7, 42, 1234])
def test_reclaim_matches_jax_two_queues(seed):
    assert_equal(both(lambda pkg: spec_cluster(storm_spec(seed, 2), pkg), RECLAIM_CONF))


@pytest.mark.parametrize("seed", [7, 42, 1234, 99])
@pytest.mark.parametrize("n_queues", [1, 2])
def test_reclaim_then_preempt_matches_jax(seed, n_queues):
    assert_equal(both(lambda pkg: spec_cluster(storm_spec(seed, n_queues), pkg), FULL_CONF))


def floor_cluster(pkg, preemptor_cpu):
    """One full node held by a min_member=3 gang of four 1000m pods; a
    pending preemptor of ``preemptor_cpu`` in another job of the same
    queue.  The floor allows exactly ONE eviction from the cohort."""
    b = Twin(pkg)
    b.queue("default")
    b.node("n0", 4000, 8 * GIB)
    b.group("g", min_member=3, phase="Running")
    for t in range(4):
        b.pod(f"g-{t}", "g", 1000, 256 * MIB, node="n0", phase="Running")
    b.group("hi")
    b.pod("hi-0", "hi", preemptor_cpu, 128 * MIB, priority=10)
    return b.cache


def test_gang_floor_blocks_second_eviction():
    """A preemptor needing TWO victims from a cohort one above its floor
    gets nothing committed (the statement discards)."""
    evlog, statuses, _, floors_ok = assert_equal(both(lambda pkg: floor_cluster(pkg, 2000.0),
                                                      PREEMPT_CONF))
    assert evlog == ()
    assert statuses["hi-0"][0] == "PENDING"
    assert sum(statuses[f"g-{t}"][0] == "RUNNING" for t in range(4)) == 4


def test_gang_floor_allows_exactly_one_eviction():
    evlog, statuses, _, _ = assert_equal(both(lambda pkg: floor_cluster(pkg, 1000.0),
                                              PREEMPT_CONF))
    assert len(evlog) == 1 and evlog[0][1] == "preempt"
    assert statuses["hi-0"][0] == "PIPELINED"
    assert sum(statuses[f"g-{t}"][0] == "RUNNING" for t in range(4)) == 3


def _mutate(pkg, cache, cycle):
    """``tests/test_evict_parity.py``'s churn between cycles, keyed on task
    names: evict a rotating slice of the running tasks, then add two storm
    pods."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    for job in sorted(cache.jobs.values(), key=lambda j: j.name):
        running = sorted((t for t in job.tasks.values()
                          if t.status.name == "RUNNING" and t.node_name),
                         key=lambda t: t.name)
        for i, task in enumerate(running):
            if (i + cycle) % 5 == 0:
                cache.evict(task, "fuzz churn")
    for p in range(2):
        pod = objects.PodSpec(
            name=f"mut{cycle}-{p}", namespace="default",
            containers=[{"cpu": 500.0, "memory": 64 * MIB}], priority=6 + (cycle + p) % 3,
            annotations={objects.GROUP_NAME_ANNOTATION: "storm-q0"})
        pod.creation_timestamp = TS0 + 10.0 + cycle + p * 1e-6
        cache.add_pod(pod)


@pytest.mark.parametrize("seed", [11, 22])
def test_mutation_trajectory_matches_jax(seed):
    """Five reclaim + preempt cycles over a churning two-queue storm: every
    cycle's evictions, statuses and binds equal, the gang floor held."""
    traj = {}
    for pkg in PKGS:
        cache = spec_cluster(storm_spec(seed, 2), pkg)
        out = []
        for cycle in range(5):
            res = run_session(pkg, cache, FULL_CONF)
            assert res[3], f"gang floor violated at cycle {cycle}"
            out.append(res[:3])
            _mutate(pkg, cache, cycle)
        traj[pkg] = out
    assert traj["scheduler_tpu_torch"] == traj["scheduler_tpu"]
    assert any(cycle[0] for cycle in traj["scheduler_tpu"])


# -- tests/test_sweep.py: the sweep memo and the victim pre-gate -----------------------

def sweep_preempt_cluster(pkg, n_nodes=8, dynamic=False):
    """``tests/test_sweep.py::_preempt_cluster``: low-priority running gangs
    fill the nodes, a high-priority pending gang needs preemption (one pod
    selecting zone z0); with ``dynamic`` one more pod asks a host port."""
    b = Twin(pkg)
    b.queue("default")
    b.cache.add_priority_class("high", 100)
    for i in range(n_nodes):
        b.node(f"n{i:02d}", 4000, 8 * GIB, labels={"zone": f"z{i % 2}"})
    for j in range(n_nodes):
        b.group(f"low{j}", phase="Running")
        for t in range(2):
            b.pod(f"low{j}-{t}", f"low{j}", 1500, 2 * GIB, node=f"n{j:02d}", phase="Running")
    b.group("hi", min_member=2, priority_class="high")
    for t in range(2):
        b.pod(f"hi-{t}", "hi", 2500, 3 * GIB, priority=100,
              selector={"zone": "z0"} if t == 0 else None)
    if dynamic:
        b.pod("dyn-0", "hi", 2500, 3 * GIB, priority=100, host_ports=[9999])
    return b.cache


def sweep_reclaim_cluster(pkg, n_nodes=6):
    """``tests/test_sweep.py::_reclaim_cluster``: queue qa holds every
    node, qb starves."""
    b = Twin(pkg)
    b.queue("qa")
    b.queue("qb")
    for i in range(n_nodes):
        b.node(f"n{i:02d}", 4000, 8 * GIB)
    for j in range(n_nodes):
        b.group(f"hog{j}", "qa", phase="Running")
        for t in range(2):
            b.pod(f"hog{j}-{t}", f"hog{j}", 2000, 4 * GIB, node=f"n{j:02d}", phase="Running")
    b.group("starved", "qb")
    b.pod("starved-0", "starved", 2000, 4 * GIB)
    return b.cache


SWEEP_CASES = {
    "preempt": (sweep_preempt_cluster, SWEEP_PREEMPT_CONF),
    "preempt-dynamic": (lambda pkg: sweep_preempt_cluster(pkg, dynamic=True), SWEEP_PREEMPT_CONF),
    "reclaim": (sweep_reclaim_cluster, SWEEP_RECLAIM_CONF),
    "reclaim-tiered": (sweep_reclaim_cluster, TIERED_RECLAIM_CONF),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_and_gate_match_the_reference_sweep(case):
    """The SweepCache contract: the port's memoized sweep and victim
    pre-gate give the JAX package's evictions and binds with its memo and
    gate on, off (the reference per-task sweep) and ungated."""
    build, conf_text = SWEEP_CASES[case]
    port = run_session("scheduler_tpu_torch", build("scheduler_tpu_torch"), conf_text)
    for env in ((), (("SCHEDULER_TPU_SWEEP", "0"),), (("SCHEDULER_TPU_VICTIM_GATE", "0"),)):
        ref = run_session("scheduler_tpu", build("scheduler_tpu"), conf_text, env)
        assert port[:3] == ref[:3], env
    assert port[0], "expected victims"


def test_victim_gate_fuzz_matches_ungated_jax():
    """``tests/test_sweep.py::test_victim_gate_fuzz_parity``'s random
    two-queue clusters: the port (gated) equals the JAX package ungated,
    under both victim confs."""
    for seed in range(6):
        rng = np.random.default_rng(seed)

        def build(pkg, rng=rng):
            b = Twin(pkg)
            b.queue("qa", weight=int(rng.integers(1, 3)))
            b.queue("qb", weight=int(rng.integers(1, 3)))
            n_nodes = int(rng.integers(3, 8))
            for i in range(n_nodes):
                b.node(f"n{i:02d}", 64000, 128 * GIB)
            for j in range(int(rng.integers(2, n_nodes + 2))):
                q = "qa" if rng.random() < 0.7 else "qb"
                b.group(f"run{j}", q, min_member=int(rng.integers(1, 3)), phase="Running")
                for t in range(int(rng.integers(1, 4))):
                    cpu = float(rng.integers(1, 3) * 1000)
                    mem = float(rng.integers(1, 5)) * GIB
                    b.pod(f"run{j}-{t}", f"run{j}", cpu, mem,
                          node=f"n{int(rng.integers(0, n_nodes)):02d}", phase="Running")
            for j in range(int(rng.integers(1, 4))):
                b.group(f"want{j}", "qb", phase=str(rng.choice(["Inqueue", "Running"])))
                for t in range(int(rng.integers(1, 3))):
                    cpu = float(rng.integers(1, 3) * 1000)
                    mem = float(rng.integers(1, 5)) * GIB
                    b.pod(f"want{j}-{t}", f"want{j}", cpu, mem,
                          priority=int(rng.integers(0, 120)))
            return b.cache

        state = rng.bit_generator.state
        for conf_text in (SWEEP_PREEMPT_CONF, SWEEP_RECLAIM_CONF):
            outs = []
            for pkg, env in (("scheduler_tpu_torch", ()),
                             ("scheduler_tpu", (("SCHEDULER_TPU_VICTIM_GATE", "0"),))):
                rng.bit_generator.state = copy.deepcopy(state)
                outs.append(run_session(pkg, build(pkg), conf_text, env)[:3])
            assert outs[0] == outs[1], f"seed {seed}"


def test_sweep_cache_memoizes_by_signature():
    """``SweepCache``: one best-first list a task signature (the same list
    object for a second task of that signature), equal to the reference
    sweep with the static predicate; None for a scan-dynamic task; reclaim's
    name-ordered passing set."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.utils.sweep import SweepCache, full_sweep

    cache = sweep_preempt_cluster("scheduler_tpu_torch", dynamic=True)
    ssn = open_session(cache, parse_scheduler_conf(SWEEP_PREEMPT_CONF).tiers, device="cpu")
    sweep = SweepCache(ssn)
    assert sweep.enabled
    tasks = {t.name: t for job in ssn.jobs.values() for t in job.tasks.values()}
    first = sweep.ordered_nodes(tasks["hi-1"])
    assert first is not None
    assert [n.name for n in first] == [
        n.name for n in full_sweep(ssn, tasks["hi-1"], ssn.static_predicate_fn)]
    assert sweep.ordered_nodes(tasks["hi-1"]) is first
    zoned = sweep.ordered_nodes(tasks["hi-0"])
    assert {n.node.labels["zone"] for n in zoned} == {"z0"}
    assert sweep.ordered_nodes(tasks["dyn-0"]) is None
    passing = sweep.passing_nodes(tasks["hi-0"])
    assert [n.name for n in passing] == sorted(n.name for n in zoned)
    close_session(ssn)


# -- the registry, config 4's reclaim and the production conf ------------------------

def test_registry_equals_jax():
    """Every action of the JAX registry resolves in the port's, and the
    port registers no other."""
    from scheduler_tpu.framework import registry as jax_registry
    from scheduler_tpu_torch.framework import get_action
    from scheduler_tpu_torch.framework import registry as torch_registry

    names = set(jax_registry._actions)
    assert names == {"enqueue", "allocate", "backfill", "preempt", "reclaim"}
    assert set(torch_registry._actions) == names
    for name in sorted(names):
        assert get_action(name).name() == name


def config4_twin(pkg, scale=0.02):
    """BASELINE config 4 before its reclaim at ``scale``: the port's
    ``harness.make_reclaim_cluster`` and the same recipe with the JAX
    package's objects."""
    if pkg == "scheduler_tpu_torch":
        from scheduler_tpu_torch.harness import make_reclaim_cluster

        return make_reclaim_cluster(scale).cache
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache_mod = importlib.import_module(f"{pkg}.cache.cache")
    gang, n_nodes, n_run, n_pend = 50, int(1000 * scale), int(25_000 * scale), int(50_000 * scale)
    slots = n_run // n_nodes + 1
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    for k, name in enumerate(("fat", "thin")):
        queue = objects.Queue(name=name, weight=1)
        queue.creation_timestamp = TS0 + k * 1e-6
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
            pod = objects.PodSpec(
                name=f"{name}-{t}", namespace="d",
                containers=[{"cpu": 2000.0, "memory": 4 * GIB}],
                annotations={objects.GROUP_NAME_ANNOTATION: name},
                node_name=f"n{(first + t) % n_nodes:05d}" if running else "",
                phase="Running" if running else "Pending")
            pod.creation_timestamp = ts + t * 1e-6
            cache.add_pod(pod)

    n_fat = n_run // gang
    for j in range(n_fat):
        add_gang(f"fat{j}", "fat", TS0 + 1.0 + j, True, j * gang)
    for j in range(n_pend // gang):
        add_gang(f"thin{j}", "thin", TS0 + 1.0 + n_fat + j, False, j * gang)
    return cache


def test_config4_reclaim_then_allocate_matches_jax():
    """Config 4 at 2 %: reclaim takes ``fat`` (overused) down for ``thin``,
    one victim a thin job, each pipelined onto what its victim frees; then
    allocate fills the idle slots."""
    port = assert_equal(both(config4_twin, CONFIG4_CONF))
    evicted = {name.rsplit("-", 1)[0] for name, _ in port[0]}
    assert port[0] and all(g.startswith("fat") for g in evicted)
    statuses = [s for s, _ in port[1].values()]
    assert statuses.count("PIPELINED") == len(port[0]) and port[2]


def production_storm(pkg, seed):
    """A storm cluster (``storm_spec``) with a zone label on every node and
    a pending gang selecting one: every action of the production conf finds
    work."""
    spec = storm_spec(seed, 2)
    spec["nodes"] = [(name, alloc, {"labels": {"zone": f"z{i % 2}"}})
                     for i, (name, alloc) in enumerate(spec["nodes"])]
    spec["groups"].append(("zoned", 2, "q1"))
    spec["pods"] += [(f"zoned-{t}", "zoned", {"cpu": 500.0, "memory": 64 * MIB}, 3,
                      {"node_selector": {"zone": "z1"}}) for t in range(3)]
    return spec_cluster(spec, pkg)


@pytest.mark.parametrize("route", ["fused", "device"])
@pytest.mark.parametrize("cluster", ["storm-7", "storm-42", "config2-64x600"])
def test_production_conf_run_once_matches_jax(tmp_path, monkeypatch, route, cluster):
    """``deploy/scheduler-conf.yaml`` (enqueue, reclaim, allocate, backfill,
    preempt over the JAX default tiers) through ``Scheduler.run_once`` in
    both packages; with the static-row limit at 1 byte allocate takes the
    device route in both.  Binds, evictions and PodGroup phases equal."""
    from scheduler_tpu.scheduler import Scheduler as JaxScheduler
    from scheduler_tpu_torch.actions import allocate as torch_allocate
    from scheduler_tpu_torch.scheduler import Scheduler

    if route == "device":
        monkeypatch.setenv("SCHEDULER_TPU_FUSED_STATIC_LIMIT", "1")
        monkeypatch.setenv("SCHEDULER_TORCH_FUSED_STATIC_LIMIT", "1")
    conf = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "deploy", "scheduler-conf.yaml")

    def build(pkg):
        if cluster.startswith("storm"):
            return production_storm(pkg, int(cluster.split("-")[1]))
        cache = kubemark_twin(pkg, 64, 600)
        pin_shadow_timestamps(cache)
        return cache

    outs = {}
    routes = dict(torch_allocate.routes)
    for pkg, sched in (("scheduler_tpu", lambda c: JaxScheduler(c, scheduler_conf=conf)),
                       ("scheduler_tpu_torch",
                        lambda c: Scheduler(c, scheduler_conf=conf, device="cpu"))):
        cache = build(pkg)
        sched(cache).run_once()
        # PodGroup phases by name; the shadow groups of bare pods are named
        # after the pod's UID (a process-global counter): by count.
        phases = [(uid, job.pod_group.status.phase) for uid, job in cache.jobs.items()
                  if job.pod_group is not None]
        outs[pkg] = (dict(cache.binder.binds), list(cache.evictor.evicts),
                     sorted(p if "podgroup-" not in p[0] else ("", p[1]) for p in phases))
    assert outs["scheduler_tpu_torch"] == outs["scheduler_tpu"]
    assert outs["scheduler_tpu_torch"][0]
    assert torch_allocate.routes[route] == routes[route] + 1
    if cluster.startswith("storm"):
        assert outs["scheduler_tpu_torch"][1], "expected evictions"
