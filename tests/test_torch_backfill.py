"""The port's enqueue and host backfill against the JAX package, on the CPU.

The same clusters are built in both packages (same objects, same
timestamps) and run through the same actions; binds, task statuses and
nodes, FitErrors strings and the ``backfill`` evidence must be equal (all
keyed by name: UIDs are a process-global counter).  The fixtures are those
of ``tests/test_backfill_parity.py`` in its host flavor (the population
waves, the bind-failure boundary of the cohort fast-start, the fallback's
complete FitErrors record, the mutation trajectory), the static-predicate
signatures of ``utils/sweep.py``, and a small trajectory of the default
conf (enqueue, allocate, backfill over the default tiers) with completions
between cycles, which also compares PodGroup phases and the engine cache's
outcomes.  The JAX side of the default conf runs proportion's device
water-fill through ``jax.enable_x64`` put in place of
``jax.experimental.enable_x64`` by an autouse fixture of this module.
"""

import importlib

import jax
import jax.experimental
import numpy as np
import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import _objects_of
from scheduler_tpu_torch.harness.synthetic import pin_shadow_timestamps

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
TS0 = 1_700_000_000.0
GIB = 1024.0**3
ZONES = ("za", "zb")

BACKFILL_CONF = """
actions: "backfill"
tiers:
- plugins:
  - name: predicates
"""


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    monkeypatch.delenv("SCHEDULER_TPU_BACKFILL", raising=False)


class Builder:
    """A cache of package ``pkg`` and its objects, with creation
    timestamps in build order (the same in both packages)."""

    def __init__(self, pkg):
        self.pkg = pkg
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

    def queue(self, name, weight=1, capability=None):
        self.cache.add_queue(self._stamp(self.objects.Queue(
            name=name, weight=weight, capability=dict(capability or {}))))

    def node(self, name, alloc, labels=None, pods=110):
        self.cache.add_node(self.objects.NodeSpec(
            name=name, allocatable=dict(alloc, pods=pods), labels=dict(labels or {})))

    def group(self, name, queue="default", min_member=1, phase="Inqueue", min_resources=None):
        pg = self.objects.PodGroup(name=name, namespace="default", queue=queue,
                                   min_member=min_member, min_resources=min_resources)
        pg.status.phase = phase
        self.cache.add_pod_group(self._stamp(pg))

    def pod(self, name, group=None, req=None, node="", phase="Pending", selector=None,
            host_ports=(), **extra):
        pod = self.objects.PodSpec(
            name=name, namespace="default", containers=[dict(req)] if req else [],
            node_name=node, phase=phase, node_selector=dict(selector or {}),
            annotations={self.objects.GROUP_NAME_ANNOTATION: group} if group else {},
            scheduler_name="" if group else "volcano", host_ports=list(host_ports))
        for kind, value in extra.items():
            setattr(pod, kind, _objects_of(self.objects, kind, value))
        self.cache.add_pod(self._stamp(pod))
        pin_shadow_timestamps(self.cache)
        return pod


def run_actions(cache, pkg, conf_text, actions=None, patch_allocate=None):
    """One session of ``conf_text`` (its action list, or ``actions``): the
    end-of-session task (status, node) pairs and FitErrors strings, the
    binds, the PodGroup phases in the cache, and the cycle's notes."""
    conf_mod = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    phases = importlib.import_module(f"{pkg}.utils.phases")
    conf = conf_mod.parse_scheduler_conf(conf_text) if conf_text else \
        conf_mod.load_scheduler_conf(None)
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    phases.begin()
    ssn = framework.open_session(cache, conf.tiers, **kw)
    if patch_allocate is not None:
        patch_allocate(ssn)
    for name in actions or conf.actions:
        framework.get_action(name).execute(ssn)
    statuses = {t.name: (t.status.name, t.node_name)
                for job in ssn.jobs.values() for t in job.tasks.values()}
    fes = {t.name: job.nodes_fit_errors[t.uid].error()
           for job in ssn.jobs.values() for t in job.tasks.values()
           if t.uid in job.nodes_fit_errors}
    framework.close_session(ssn)
    notes = phases.take_notes()
    phases.end()
    # PodGroup phases by name; a bare pod's shadow group is named after the
    # pod's UID (a process-global counter), so it is keyed by its pod.
    pg_phases = {(uid if "podgroup-" not in uid
                  else "shadow:" + ",".join(sorted(t.name for t in job.tasks.values()))):
                 job.pod_group.status.phase
                 for uid, job in cache.jobs.items() if job.pod_group is not None}
    return {"statuses": statuses, "fit_errors": fes, "binds": dict(cache.binder.binds),
            "pod_groups": pg_phases,
            "notes": {k: notes.get(k) for k in ("backfill", "engine_cache", "dirty")}}


# -- tests/test_backfill_parity.py's fixtures -------------------------------------

def wave_cluster(pkg, seed, n_queues=1, mode="static", shared_sigs=True):
    """``tests/test_backfill_parity.py::wave_cluster`` in package ``pkg``: a
    pod-count-tight cluster, a BestEffort wave a queue (``mode``: selectors
    only, host ports on every pod, or on every other), and a pending pod
    with a real request that backfill leaves alone."""
    rng = np.random.default_rng(seed)
    b = Builder(pkg)
    queues = [f"q{i}" for i in range(n_queues)]
    for i, q in enumerate(queues):
        b.queue(q, weight=i + 1)
    n_nodes = int(rng.integers(5, 9))
    pods_limit = int(rng.integers(3, 6))
    names = [f"n{i:02d}" for i in range(n_nodes)]
    for i, name in enumerate(names):
        b.node(name, {"cpu": 4000, "memory": 8 * GIB},
               labels={"zone": ZONES[i % len(ZONES)], "host": name}, pods=pods_limit)
    b.group("occ", queues[0], phase="Running")
    k = 0
    for name in names:
        for _ in range(int(rng.integers(0, pods_limit))):
            b.pod(f"occ-{k}", "occ", {"cpu": 100, "memory": 64 * 1024**2}, node=name,
                  phase="Running")
            k += 1
    for q in queues:
        lane = f"wave-{q}"
        b.group(lane, q)
        for p in range(int(rng.integers(6, 12))):
            if shared_sigs:
                sel = {"zone": ZONES[p % 3 % len(ZONES)]} if p % 3 else None
            else:
                sel = {"host": names[int(rng.integers(0, n_nodes))]}
            dynamic = mode == "dynamic" or (mode == "mixed" and p % 2 == 0)
            b.pod(f"{lane}-{p}", lane, selector=sel, host_ports=[30000 + p] if dynamic else ())
    b.group("real", queues[0])
    b.pod("real-0", "real", {"cpu": 500, "memory": 128 * 1024**2})
    return b


def twins(build):
    """``build(pkg)`` in both packages: {pkg: Builder}."""
    return {pkg: build(pkg) for pkg in PKGS}


@pytest.mark.parametrize("seed", [7, 42])
@pytest.mark.parametrize("n_queues", [1, 2])
@pytest.mark.parametrize("mode", ["static", "dynamic", "mixed"])
@pytest.mark.parametrize("shared_sigs", [True, False])
def test_backfill_matches_jax(seed, n_queues, mode, shared_sigs):
    out = {pkg: run_actions(b.cache, pkg, BACKFILL_CONF)
           for pkg, b in twins(lambda pkg: wave_cluster(pkg, seed, n_queues, mode,
                                                        shared_sigs)).items()}
    assert out["scheduler_tpu_torch"] == out["scheduler_tpu"]
    port = out["scheduler_tpu_torch"]
    assert port["statuses"]["real-0"] == ("PENDING", "")
    bf = port["notes"]["backfill"]
    assert bf["flavor"] == "host" and bf["reason"] == "flavor host"
    assert bf["host_binds"] > 0 and bf["predicate_calls_host"] > 0


def _tight_cluster(pkg, limits, occupied, n_pods):
    b = Builder(pkg)
    b.queue("default")
    b.group("occ", phase="Running")
    k = 0
    for i, (limit, occ) in enumerate(zip(limits, occupied)):
        b.node(f"n{i}", {"cpu": 4000, "memory": 8 * GIB}, pods=limit)
        for _ in range(occ):
            b.pod(f"occ-{k}", "occ", {"cpu": 100, "memory": 64 * 1024**2}, node=f"n{i}",
                  phase="Running")
            k += 1
    b.group("bf")
    for p in range(n_pods):
        b.pod(f"bf-{p}", "bf")
    return b


def test_bind_failure_boundary_matches_jax():
    """bf-0's bind on n0 fails once, so it lands on n1; the fast-start
    boundary is the failed node, so bf-1 retries n0 and binds there."""
    out = {}
    for pkg, b in twins(lambda pkg: _tight_cluster(pkg, (5, 5, 5), (0, 0, 0), 2)).items():
        tripped = []

        def patch(ssn):
            orig = ssn.allocate

            def allocate(task, node_name):
                if node_name == "n0" and not tripped:
                    tripped.append(task.name)
                    raise RuntimeError("injected transient bind failure")
                return orig(task, node_name)

            ssn.allocate = allocate

        out[pkg] = (run_actions(b.cache, pkg, BACKFILL_CONF, patch_allocate=patch), tripped)
    assert out["scheduler_tpu_torch"] == out["scheduler_tpu"]
    port, tripped = out["scheduler_tpu_torch"]
    assert tripped == ["bf-0"]
    assert port["statuses"]["bf-0"] == ("BINDING", "n1")
    assert port["statuses"]["bf-1"] == ("BINDING", "n0")


def test_fast_start_fallback_matches_jax():
    """bf-1 fast-starts past n0, finds nothing, and sweeps the skipped
    prefix into the same FitErrors: all three nodes are in its record."""
    out = {pkg: run_actions(b.cache, pkg, BACKFILL_CONF)
           for pkg, b in twins(lambda pkg: _tight_cluster(pkg, (1, 1, 1), (1, 0, 1), 2)).items()}
    assert out["scheduler_tpu_torch"] == out["scheduler_tpu"]
    port = out["scheduler_tpu_torch"]
    assert port["statuses"]["bf-0"] == ("BINDING", "n1")
    assert "3 node(s) pod number exceeded" in port["fit_errors"]["bf-1"]


def _mutate(b, cycle):
    """``tests/test_backfill_parity.py::_mutate``: evict a rotating slice of
    the placed pods, add three wave pods (every third scan-dynamic)."""
    for job in sorted(b.cache.jobs.values(), key=lambda j: j.name):
        placed = sorted((t for t in job.tasks.values()
                         if t.node_name and t.status.name in ("BOUND", "RUNNING")),
                        key=lambda t: t.name)
        for i, task in enumerate(placed):
            if (i + cycle) % 4 == 0:
                b.cache.evict(task, "fuzz churn")
    for p in range(3):
        sel = {"zone": ZONES[(cycle + p) % len(ZONES)]} if p % 2 else None
        b.pod(f"mut{cycle}-{p}", "wave-q0", selector=sel,
              host_ports=[31000 + cycle * 10 + p] if p % 3 == 0 else ())


@pytest.mark.parametrize("seed", [11, 22])
def test_mutation_trajectory_matches_jax(seed):
    out = {}
    for pkg, b in twins(lambda pkg: wave_cluster(pkg, seed, 2, "mixed")).items():
        traj = []
        for cycle in range(4):
            traj.append(run_actions(b.cache, pkg, BACKFILL_CONF))
            _mutate(b, cycle)
        out[pkg] = traj
    assert out["scheduler_tpu_torch"] == out["scheduler_tpu"]


# -- utils/sweep.py ------------------------------------------------------------------

SIG_PODS = (
    {},
    {"selector": {"zone": "za"}},
    {"selector": {"zone": "za", "disk": "ssd"}},
    {"tolerations": [("gpu", "Exists", "", "NoSchedule")]},
    {"tolerations": [("gpu", "Equal", "a100", "NoSchedule"), ("spot", "Exists", "", "")]},
    {"affinity": {"node_required": [[("zone", "In", ("za", "zb"))]]}},
    {"affinity": {"node_preferred": [(5, [("disk", "In", ("ssd",))])]}},
    {"selector": {"zone": "zb"},
     "affinity": {"node_required": [[("zone", "NotIn", ("za",))]],
                  "node_preferred": [(1, [("zone", "In", ("zb",))])]}},
    {"host_ports": [8080]},
    {"affinity": {"pod_affinity": [({"app": "db"}, "zone")]}},
    {"affinity": {"pod_anti_affinity": [({"app": "web"}, "kubernetes.io/hostname")]}},
)


def test_static_predicate_sig_matches_jax():
    """The static-predicate signature of pods with selectors, tolerations
    and node affinity, equal in both packages; None for host ports and
    inter-pod (anti-)affinity."""
    sigs = {}
    for pkg in PKGS:
        b = Builder(pkg)
        b.queue("default")
        b.group("g")
        sweep = importlib.import_module(f"{pkg}.utils.sweep")
        out = []
        for i, spec in enumerate(SIG_PODS):
            extra = {k: v for k, v in spec.items() if k in ("tolerations", "affinity")}
            b.pod(f"p{i}", "g", selector=spec.get("selector"),
                  host_ports=spec.get("host_ports", ()), **extra)
            task = next(t for t in b.cache.jobs["default/g"].tasks.values()
                        if t.name == f"p{i}")
            out.append(sweep.static_predicate_sig(task))
        sigs[pkg] = out
    assert sigs["scheduler_tpu_torch"] == sigs["scheduler_tpu"]
    port = sigs["scheduler_tpu_torch"]
    assert port[-3:] == [None, None, None] and None not in port[:-3]
    assert len(set(port[:-3])) == len(SIG_PODS) - 3


# -- the default conf: enqueue, allocate, backfill -----------------------------------

def default_conf_cluster(pkg):
    """Two queues (``batch`` with a capability that proportion's enqueue
    gate holds), 24 zone-labelled nodes each running one service pod, bare
    sleep pods (half selecting a zone), backlog gangs created Pending with
    their minimum resources (three that fit, two whose 9-cpu pods no node
    can hold, three in ``batch`` whose capability admits two: the third asks
    more than it), and
    BestEffort bare pods (half selecting a zone, one a zone no node has)."""
    b = Builder(pkg)
    b.queue("default")
    b.queue("batch", capability={"cpu": 20000, "memory": 64 * GIB})
    for i in range(24):
        b.node(f"n{i:02d}", {"cpu": 8000, "memory": 16 * GIB},
               labels={"zone": f"z{i % 3}"}, pods=10)
    b.group("svc", phase="Running")
    for i in range(24):
        b.pod(f"svc-{i:02d}", "svc", {"cpu": 1000, "memory": GIB}, node=f"n{i:02d}",
              phase="Running")
    for t in range(30):
        b.pod(f"sleep-{t:02d}", req={"cpu": [100, 200, 500][t % 3], "memory": (1 + t % 2) * GIB},
              selector={"zone": f"z{t % 3}"} if t % 2 == 0 else None)
    for g, (queue, size, cpu, mem) in enumerate(
            [("default", 3, 2000, 2 * GIB)] * 3 + [("default", 2, 9000, 4 * GIB)] * 2
            + [("batch", 4, 2000, 2 * GIB)] * 2 + [("batch", 6, 4000, 2 * GIB)]):
        name = f"gang-{g}"
        b.group(name, queue, min_member=size, phase="Pending",
                min_resources={"cpu": size * cpu, "memory": size * mem})
        for t in range(size):
            b.pod(f"{name}-{t}", name, {"cpu": cpu, "memory": mem})
    for t in range(8):
        b.pod(f"be-{t}", selector={"zone": f"z{t % 3}"} if t % 2 else None)
    b.pod("be-nowhere", selector={"zone": "z9"})
    return b


@pytest.mark.parametrize("dirty_delta", ["1", "0"])
def test_default_conf_trajectory_matches_jax(dirty_delta, monkeypatch):
    """Four cycles of the default conf (``Scheduler.run``'s conf with none
    given); before cycles 3 and 4 two running service pods complete.  Every
    cycle's binds, statuses, FitErrors, PodGroup phases, backfill evidence
    and engine-cache outcome and refresh evidence equal the JAX package's.
    The hits refresh the dirty node rows (``sparse``), or with the
    dirty-set refresh off in both packages the whole node tensors
    (``full``)."""
    monkeypatch.setenv("SCHEDULER_TORCH_DIRTY_DELTA", dirty_delta)
    monkeypatch.setenv("SCHEDULER_TPU_DIRTY_DELTA", dirty_delta)
    out = {}
    for pkg, b in twins(default_conf_cluster).items():
        engine_cache = importlib.import_module(f"{pkg}.ops.engine_cache")
        engine_cache.clear()
        traj = []
        for cycle in range(4):
            if cycle >= 2:
                for i in (2 * cycle, 2 * cycle + 5):
                    b.cache.delete_pod(next(t.pod for t in b.cache.jobs["default/svc"]
                                            .tasks.values() if t.name == f"svc-{i:02d}"))
            traj.append(run_actions(b.cache, pkg, None))
        engine_cache.clear()
        out[pkg] = traj
    port, ref = out["scheduler_tpu_torch"], out["scheduler_tpu"]
    for i, (got, want) in enumerate(zip(port, ref)):
        assert got == want, f"cycle {i}: the port differs from the JAX package"
    first = port[0]
    assert first["pod_groups"]["default/gang-0"] == "Running"
    assert first["pod_groups"]["default/gang-7"] == "Pending"  # over batch's capability
    assert first["statuses"]["gang-3-0"] == ("PENDING", "")
    assert first["statuses"]["be-1"][0] == "BINDING"
    assert "be-nowhere" in first["fit_errors"]
    assert [c["notes"]["engine_cache"] for c in port] == ["miss", "rebuild", "hit", "hit"]
    if dirty_delta == "1":
        assert all(c["notes"]["dirty"]["mode"] == "sparse" for c in port[2:])
        assert port[2]["notes"]["dirty"]["rows_scattered"] > 0
    else:
        assert all(c["notes"]["dirty"]["mode"] == "full" for c in port[2:])
