"""The port's eviction engine (``SCHEDULER_TORCH_EVICT=device``) against the
JAX package's (``SCHEDULER_TPU_EVICT=device``) and the port's host walk, on
the CPU.

The same clusters are built in both packages (``chip_smoke.spec_cluster``,
same objects and timestamps) and run through the same actions under each
flavor; the committed evictions (in commit order, captured at the cache),
every task's status and node, the binds and the ``evict`` and ``victims``
evidence blocks must be equal (the engine's phase times by their keys
only).  Before a case holds the port to the JAX device flavor, it checks
that the JAX device flavor equals the JAX host flavor on that fixture.
Fixtures: ``tests/test_evict_parity.py``'s storms, gang-floor clusters and
mutation trajectory, a small ``PreemptStormConfig`` storm, and
``deploy/scheduler-conf.yaml`` through ``Scheduler.run_once`` on the fused
and the device routes; then each of the engine's decline reasons, word for
word, and a scalar request's per-task fallback to the host walk.  The JAX
side runs proportion's device water-fill through ``jax.enable_x64`` put in
place of ``jax.experimental.enable_x64`` by an autouse fixture of this
module.
"""

import importlib
import itertools
import os

import jax
import jax.experimental
import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import env_flag, spec_cluster, storm_spec
from tests.test_torch_reclaim_preempt import (
    FULL_CONF,
    PREEMPT_CONF,
    RECLAIM_CONF,
    Twin,
    _mutate,
    floor_cluster,
    production_storm,
)

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
FLAG = {"scheduler_tpu": "SCHEDULER_TPU_EVICT", "scheduler_tpu_torch": "SCHEDULER_TORCH_EVICT"}
GIB = 1024.0**3
MIB = 1024.0**2
ENGINE_PHASES = {"score", "mask", "plan", "replay"}


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    for name in ("SCHEDULER_TPU_EVICT", "SCHEDULER_TORCH_EVICT", "SCHEDULER_TPU_SWEEP",
                 "SCHEDULER_TPU_VICTIM_GATE", "SCHEDULER_TPU_FUSED_STATIC_LIMIT",
                 "SCHEDULER_TORCH_FUSED_STATIC_LIMIT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def _uids_in_step():
    """Leave both packages' UID counters (process-global) at one value, as
    ``tests/test_torch_reclaim_preempt.py`` does."""
    yield
    import scheduler_tpu.apis.objects as jax_objects
    import scheduler_tpu_torch.apis.objects as torch_objects

    step = max(next(jax_objects._uid_counter), next(torch_objects._uid_counter))
    jax_objects._uid_counter = itertools.count(step)
    torch_objects._uid_counter = itertools.count(step)


def run_session(pkg, cache, conf_text, flavor, prepare=None):
    """One session of ``conf_text``'s actions under eviction flavor
    ``flavor``: the committed evictions (cache-seam order), the task
    (status, node) pairs, the binds, whether every gang kept its floor,
    and the ``evict`` and ``victims`` notes.  ``prepare(ssn)`` runs after
    the session opens."""
    conf_mod = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    phases = importlib.import_module(f"{pkg}.utils.phases")
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
        with env_flag(FLAG[pkg], flavor):
            conf = conf_mod.parse_scheduler_conf(conf_text)
            kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
            phases.begin()
            ssn = framework.open_session(cache, conf.tiers, **kw)
            if prepare is not None:
                prepare(ssn)
            before = {job.uid: job.ready_task_num() for job in ssn.jobs.values()
                      if job.min_available > 1}
            for name in conf.actions:
                framework.get_action(name).execute(ssn)
            statuses = {t.name: (t.status.name, t.node_name)
                        for job in ssn.jobs.values() for t in job.tasks.values()}
            floors_ok = all(job.ready_task_num() >= min(job.min_available, before[job.uid])
                            for job in ssn.jobs.values() if job.uid in before)
            framework.close_session(ssn)
            notes = phases.take_notes()
            phases.end()
    finally:
        cache.evict, cache.evict_bulk = evict, evict_bulk
    return {"evictions": tuple(evlog), "statuses": statuses,
            "binds": dict(cache.binder.binds), "floors_ok": floors_ok,
            "evict": notes.get("evict") or {}, "victims": notes.get("victims") or {}}


def evidence(block):
    """An ``evict`` note with each kind's phase split reduced to its keys."""
    out = {}
    for kind, stats in block.items():
        stats = dict(stats)
        if "phase" in stats:
            stats["phase"] = sorted(stats["phase"])
        out[kind] = stats
    return out


def outcome(res):
    return res["evictions"], res["statuses"], res["binds"]


def four_ways(build, conf_text):
    """``build(pkg)``'s cluster under both flavors in both packages, held
    to each other: the JAX device flavor to the JAX host flavor first, then
    the port's device flavor to it and to the port's host walk, with equal
    evidence.  Returns the port's device run."""
    runs = {(pkg, flavor): run_session(pkg, build(pkg), conf_text, flavor)
            for pkg in PKGS for flavor in ("host", "device")}
    jax_host, jax_dev = runs[("scheduler_tpu", "host")], runs[("scheduler_tpu", "device")]
    port_host, port_dev = (runs[("scheduler_tpu_torch", "host")],
                           runs[("scheduler_tpu_torch", "device")])
    assert outcome(jax_dev) == outcome(jax_host), "the JAX flavors differ on this fixture"
    assert outcome(port_dev) == outcome(jax_dev)
    assert outcome(port_dev) == outcome(port_host)
    for flavor in ("host", "device"):
        port, ref = runs[("scheduler_tpu_torch", flavor)], runs[("scheduler_tpu", flavor)]
        assert evidence(port["evict"]) == evidence(ref["evict"]), flavor
        assert port["victims"] == ref["victims"], flavor
        assert port["floors_ok"] and ref["floors_ok"], "gang floor violated"
    for kind, stats in port_host["evict"].items():
        assert stats == {"flavor": "host", "kind": kind, "engaged": False,
                         "reason": "flavor host"}
    for kind, stats in port_dev["evict"].items():
        assert stats["engaged"] and set(stats["phase"]) == ENGINE_PHASES, stats
        assert stats["device_picks"] == 0
    return port_dev


# -- tests/test_evict_parity.py's storms ---------------------------------------------

@pytest.mark.parametrize("seed", [7, 42, 1234])
@pytest.mark.parametrize("n_queues", [1, 2])
def test_preempt_engine_matches(seed, n_queues):
    port = four_ways(lambda pkg: spec_cluster(storm_spec(seed, n_queues), pkg), PREEMPT_CONF)
    assert port["evictions"]
    stats = port["evict"]["preempt"]
    # The engine counts replayed evictions, discarded statements' included.
    assert stats["evictions"] >= len(port["evictions"]) and stats["hunts"] > 0


@pytest.mark.parametrize("seed", [7, 42, 1234])
def test_reclaim_engine_matches_two_queues(seed):
    port = four_ways(lambda pkg: spec_cluster(storm_spec(seed, 2), pkg), RECLAIM_CONF)
    assert port["evict"]["reclaim"]["engaged"]


@pytest.mark.parametrize("seed", [7, 42, 1234, 99])
@pytest.mark.parametrize("n_queues", [1, 2])
def test_reclaim_then_preempt_engine_matches(seed, n_queues):
    port = four_ways(lambda pkg: spec_cluster(storm_spec(seed, n_queues), pkg), FULL_CONF)
    assert set(port["evict"]) == {"reclaim", "preempt"}


@pytest.mark.parametrize("cpu,evictions", [(2000.0, 0), (1000.0, 1)])
def test_gang_floor_engine_matches(cpu, evictions):
    """The gang floor cluster: a preemptor needing two victims of a cohort
    one above its floor gets nothing (the statement discards); a
    one-victim preemptor leaves the cohort exactly at its floor."""
    port = four_ways(lambda pkg: floor_cluster(pkg, cpu), PREEMPT_CONF)
    assert len(port["evictions"]) == evictions
    assert port["statuses"]["hi-0"][0] == ("PIPELINED" if evictions else "PENDING")
    assert sum(port["statuses"][f"g-{t}"][0] == "RUNNING" for t in range(4)) == 4 - evictions


@pytest.mark.parametrize("seed", [11, 22])
def test_mutation_trajectory_engine_matches(seed):
    """Five reclaim + preempt cycles over a churning two-queue storm: every
    cycle's evictions, statuses, binds and evidence equal in the four runs
    (the candidate order after a rollback included)."""
    traj = {}
    for pkg in PKGS:
        for flavor in ("host", "device"):
            cache = spec_cluster(storm_spec(seed, 2), pkg)
            out = []
            for cycle in range(5):
                res = run_session(pkg, cache, FULL_CONF, flavor)
                assert res["floors_ok"], f"gang floor violated at cycle {cycle}"
                out.append((outcome(res), evidence(res["evict"])))
                _mutate(pkg, cache, cycle)
            traj[(pkg, flavor)] = out
    outcomes = {key: [o for o, _ in t] for key, t in traj.items()}
    assert outcomes[("scheduler_tpu", "device")] == outcomes[("scheduler_tpu", "host")]
    assert outcomes[("scheduler_tpu_torch", "device")] == outcomes[("scheduler_tpu", "device")]
    assert outcomes[("scheduler_tpu_torch", "device")] == outcomes[("scheduler_tpu_torch", "host")]
    for flavor in ("host", "device"):
        assert ([e for _, e in traj[("scheduler_tpu_torch", flavor)]]
                == [e for _, e in traj[("scheduler_tpu", flavor)]])
    assert any(o[0] for o in outcomes[("scheduler_tpu_torch", "device")])


def storm_cache(pkg, cfg):
    """``harness/preempt_storm.py``'s saturated cluster and its arrivals in
    package ``pkg`` (both through the package's own wire parsers)."""
    if pkg == "scheduler_tpu_torch":
        from scheduler_tpu_torch.harness import preempt_storm

        cache = preempt_storm.seed_saturated_cache(cfg)
        preempt_storm.add_storm(cache, cfg)
        return cache
    from scheduler_tpu.connector.wire import parse_pod
    from scheduler_tpu.harness import preempt_storm as jax_storm

    jax_cfg = jax_storm.PreemptStormConfig(**{k: getattr(cfg, k) for k in (
        "seed", "nodes", "fill_per_node", "filler_gang", "filler_min_member", "storm_pods")})
    cache = jax_storm.seed_saturated_cache(jax_cfg)
    for ev in jax_storm.make_storm(jax_cfg):
        cache.add_pod(parse_pod(ev.obj, cache.scheduler_name))
    return cache


def test_preempt_storm_config_engine_matches():
    """A small ``PreemptStormConfig`` storm (8 nodes, 64 filler pods in
    gangs of 8 with minMember 4, 24 SLA-tiered arrivals) under
    ``PREEMPT_CONF`` (allocate, preempt): the storm's seeds and objects are
    the JAX harness's, and every arrival of the saturated cluster evicts."""
    from scheduler_tpu_torch.harness.preempt_storm import PREEMPT_CONF as STORM_CONF
    from scheduler_tpu_torch.harness.preempt_storm import PreemptStormConfig

    cfg = PreemptStormConfig(seed=3, nodes=8, storm_pods=24)
    port = four_ways(lambda pkg: storm_cache(pkg, cfg), STORM_CONF)
    stats = port["evict"]["preempt"]
    assert stats["evictions"] >= len(port["evictions"]) > 0
    assert stats["pipelined"] == sum(s == "PIPELINED" for s, _ in port["statuses"].values())


@pytest.mark.parametrize("route", ["fused", "device"])
def test_production_conf_run_once_engine_matches(monkeypatch, route):
    """``deploy/scheduler-conf.yaml`` (enqueue, reclaim, allocate, backfill,
    preempt over the JAX default tiers) through ``Scheduler.run_once`` on
    the storm-7 cluster, on allocate's fused and device routes: binds,
    evictions and PodGroup phases of the four runs equal, the port's
    engine engaged."""
    from scheduler_tpu.scheduler import Scheduler as JaxScheduler
    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils import phases

    if route == "device":
        monkeypatch.setenv("SCHEDULER_TPU_FUSED_STATIC_LIMIT", "1")
        monkeypatch.setenv("SCHEDULER_TORCH_FUSED_STATIC_LIMIT", "1")
    conf = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "deploy", "scheduler-conf.yaml")
    outs, notes = {}, {}
    for pkg, sched in (("scheduler_tpu", lambda c: JaxScheduler(c, scheduler_conf=conf)),
                       ("scheduler_tpu_torch",
                        lambda c: Scheduler(c, scheduler_conf=conf, device="cpu"))):
        for flavor in ("host", "device"):
            cache = production_storm(pkg, 7)
            with env_flag(FLAG[pkg], flavor):
                if pkg == "scheduler_tpu_torch":
                    phases.begin()
                sched(cache).run_once()
                if pkg == "scheduler_tpu_torch":
                    notes[flavor] = phases.take_notes().get("evict")
                    phases.end()
            pg = sorted((uid if "podgroup-" not in uid else "", job.pod_group.status.phase)
                        for uid, job in cache.jobs.items() if job.pod_group is not None)
            outs[(pkg, flavor)] = (dict(cache.binder.binds), list(cache.evictor.evicts), pg)
    assert outs[("scheduler_tpu", "device")] == outs[("scheduler_tpu", "host")]
    assert outs[("scheduler_tpu_torch", "device")] == outs[("scheduler_tpu", "device")]
    assert outs[("scheduler_tpu_torch", "device")] == outs[("scheduler_tpu_torch", "host")]
    assert outs[("scheduler_tpu_torch", "device")][1], "expected evictions"
    assert notes["device"]["preempt"]["engaged"] and notes["device"]["reclaim"]["engaged"]
    assert notes["host"]["preempt"]["reason"] == "flavor host"


# -- the exactness gate: each decline reason, word for word ---------------------------

def _fake_victim_fn(preemptor, preemptees):
    return list(preemptees)


def _task_order_fn(left, right):
    return 0


DECLINES = {
    # name: (kind, conf, session edit before the engine is built, reason)
    "flavor host": ("preempt", PREEMPT_CONF, None, "flavor host"),
    "unmodeled victim plugins": (
        "preempt", PREEMPT_CONF,
        lambda ssn: ssn.preemptable_fns.__setitem__("priority", _fake_victim_fn),
        "unmodeled victim plugins: priority"),
    "non-builtin task order": (
        "preempt", PREEMPT_CONF,
        lambda ssn: ssn.task_order_fns.__setitem__("drf", _task_order_fn),
        "non-builtin task order"),
    "proportion without queue attrs": (
        "reclaim", RECLAIM_CONF,
        lambda ssn: setattr(ssn.plugins["proportion"], "queue_attrs", {}),
        "proportion victim fn without queue attrs"),
    "drf without session totals": (
        "preempt", PREEMPT_CONF,
        lambda ssn: setattr(ssn.plugins["drf"], "total_resource", None),
        "drf victim fn without session totals"),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_decline_reason_matches_jax(case):
    """Each gate of ``EvictEngine`` declines with the JAX engine's words,
    on the storm-42 cluster with the same session edit in both packages."""
    kind, conf_text, edit, reason = DECLINES[case]
    flavor = "host" if case == "flavor host" else "device"
    stats = {}
    for pkg in PKGS:
        conf_mod = importlib.import_module(f"{pkg}.conf")
        framework = importlib.import_module(f"{pkg}.framework")
        evict = importlib.import_module(f"{pkg}.ops.evict")
        kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
        with env_flag(FLAG[pkg], flavor):
            ssn = framework.open_session(spec_cluster(storm_spec(42, 2), pkg),
                                         conf_mod.parse_scheduler_conf(conf_text).tiers, **kw)
            if edit is not None:
                edit(ssn)
            engine = evict.EvictEngine(ssn, kind)
            engine.prime()
            stats[pkg] = engine.stats()
            assert not engine.active
            framework.close_session(ssn)
    assert stats["scheduler_tpu_torch"] == stats["scheduler_tpu"]
    assert stats["scheduler_tpu_torch"] == {"flavor": flavor, "kind": kind, "engaged": False,
                                            "reason": reason}


def scalar_cluster(pkg, scalar_running):
    """One node with four GPUs, full of 1000m fillers of a min_member 1
    job; a pending preemptor asking 1000m and naming a GPU request of 0 (a
    scalar by presence).  With ``scalar_running`` the fillers ask a GPU
    each."""
    b = Twin(pkg)
    b.queue("default")
    b.cache.add_node(b.objects.NodeSpec(name="n0", allocatable={
        "cpu": 4000.0, "memory": 8 * GIB, "pods": 110, "nvidia.com/gpu": 4.0}))
    b.group("fill", phase="Running")
    for t in range(4):
        req = {"cpu": 1000.0, "memory": 256 * MIB}
        if scalar_running:
            req["nvidia.com/gpu"] = 1.0
        b.cache.add_pod(b._stamp(b.objects.PodSpec(
            name=f"fill-{t}", namespace="default", containers=[req], node_name="n0",
            phase="Running", annotations={b.objects.GROUP_NAME_ANNOTATION: "fill"})))
    b.group("hi")
    b.cache.add_pod(b._stamp(b.objects.PodSpec(
        name="hi-0", namespace="default",
        containers=[{"cpu": 1000.0, "memory": 128 * MIB, "nvidia.com/gpu": 0.0}],
        priority=10, annotations={b.objects.GROUP_NAME_ANNOTATION: "hi"})))
    return b.cache


def test_scalar_resources_decline_matches_jax():
    """Running tasks with a scalar resource close the gate at prime, with
    the JAX engine's reason; the hunt is the host walk's."""
    runs = {(pkg, f): run_session(pkg, scalar_cluster(pkg, True), PREEMPT_CONF, f)
            for pkg in PKGS for f in ("host", "device")}
    port = runs[("scheduler_tpu_torch", "device")]
    assert outcome(runs[("scheduler_tpu", "device")]) == outcome(runs[("scheduler_tpu", "host")])
    assert outcome(port) == outcome(runs[("scheduler_tpu", "device")])
    assert outcome(port) == outcome(runs[("scheduler_tpu_torch", "host")])
    assert port["evict"] == runs[("scheduler_tpu", "device")]["evict"]
    assert port["evict"]["preempt"] == {"flavor": "device", "kind": "preempt",
                                        "engaged": False, "reason": "scalar resources in play"}


def test_scalar_request_falls_back_per_task():
    """A preemptor asking a scalar resource leaves the engine's modeled
    domain for its own hunt only (``_FallbackHunt``): the engine stays
    engaged, that task's hunt is the host walk's, and the outcome equals
    both packages' host walks and the JAX device flavor."""
    port = four_ways(lambda pkg: scalar_cluster(pkg, False), PREEMPT_CONF)
    assert port["evictions"] and port["statuses"]["hi-0"][0] == "PIPELINED"
    stats = port["evict"]["preempt"]
    assert stats["engaged"] and stats["hunts"] >= 1 and stats["evictions"] == 0
