"""The port's backfill class engine (``SCHEDULER_TORCH_BACKFILL=device``)
against the JAX package's (``SCHEDULER_TPU_BACKFILL=device``) and the
port's host sweep, on the CPU.

The same clusters are built in both packages (same objects, same
timestamps) and run through backfill under each flavor; the binds, every
task's status and node, the ``FitErrors`` strings and the ``backfill``
evidence must be equal (the engine's phase times by their keys only).
Before a case holds the port to the JAX device flavor, it checks that the
JAX device flavor equals the JAX host flavor on that fixture.  Fixtures:
``tests/test_backfill_parity.py``'s 24 population waves, its bind-failure
boundary, the fast-start fallback's complete record and the mutation
trajectory, and a 64-node, 600-pod ``BackfillWaveConfig`` wave from each
package's own harness; then each decline reason, word for word, the
engine's numpy parts (``_solve_runs``, ``derive_classes``,
``_static_signature_ids``) against the JAX package's on seeded inputs, the
engine's columnar snapshot against the JAX package's object-list one, and
the engine cache across a flip of either flavor flag.  The JAX side runs proportion's device water-fill through
``jax.enable_x64`` put in place of ``jax.experimental.enable_x64`` by an
autouse fixture of this module.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.experimental
import numpy as np
import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import env_flag
from tests.test_torch_backfill import (
    BACKFILL_CONF,
    _mutate,
    _tight_cluster,
    run_actions,
    wave_cluster,
)

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
FLAG = {"scheduler_tpu": "SCHEDULER_TPU_BACKFILL",
        "scheduler_tpu_torch": "SCHEDULER_TORCH_BACKFILL"}
ENGINE_PHASES = ["mask", "replay", "solve"]


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    for name in FLAG.values():
        monkeypatch.delenv(name, raising=False)


def run(pkg, cache, flavor, patch_allocate=None):
    """One backfill session of ``cache`` under ``flavor``: ``run_actions``'
    record with the ``backfill`` evidence's phase split reduced to its
    keys."""
    with env_flag(FLAG[pkg], flavor):
        rec = run_actions(cache, pkg, BACKFILL_CONF, patch_allocate=patch_allocate)
    bf = dict(rec["notes"]["backfill"])
    if "phase" in bf:
        bf["phase"] = sorted(bf["phase"])
    rec["notes"] = {"backfill": bf}
    return rec


def outcome(rec):
    return rec["statuses"], rec["fit_errors"], rec["binds"]


def four_ways(build, patch=None):
    """``build(pkg)``'s cache under both flavors in both packages, held to
    each other: the JAX device flavor to the JAX host flavor first, then the
    port's device flavor to it and to the port's host sweep, with equal
    evidence.  ``patch(pkg)`` makes a fresh ``patch_allocate`` for each run.  Returns
    the four records."""
    runs = {(pkg, flavor): run(pkg, build(pkg), flavor,
                               patch(pkg) if patch is not None else None)
            for pkg in PKGS for flavor in ("host", "device")}
    assert outcome(runs[("scheduler_tpu", "device")]) == outcome(runs[("scheduler_tpu", "host")]), \
        "the JAX flavors differ on this fixture"
    port_dev = runs[("scheduler_tpu_torch", "device")]
    assert outcome(port_dev) == outcome(runs[("scheduler_tpu", "device")])
    assert outcome(port_dev) == outcome(runs[("scheduler_tpu_torch", "host")])
    for flavor in ("host", "device"):
        assert (runs[("scheduler_tpu_torch", flavor)]["notes"]
                == runs[("scheduler_tpu", flavor)]["notes"]), flavor
    host_bf = runs[("scheduler_tpu_torch", "host")]["notes"]["backfill"]
    assert host_bf["flavor"] == "host" and host_bf["reason"] == "flavor host"
    bf = port_dev["notes"]["backfill"]
    assert bf["flavor"] == "device" and bf["engaged"] and bf["phase"] == ENGINE_PHASES
    assert bf["lp_noop"] is False
    return runs


# -- tests/test_backfill_parity.py's fixtures -------------------------------------

@pytest.mark.parametrize("seed", [7, 42])
@pytest.mark.parametrize("n_queues", [1, 2])
@pytest.mark.parametrize("mode", ["static", "dynamic", "mixed"])
@pytest.mark.parametrize("shared_sigs", [True, False])
def test_wave_engine_matches(seed, n_queues, mode, shared_sigs):
    runs = four_ways(lambda pkg: wave_cluster(pkg, seed, n_queues, mode, shared_sigs).cache)
    port = runs[("scheduler_tpu_torch", "device")]
    assert port["statuses"]["real-0"] == ("PENDING", "")
    bf = port["notes"]["backfill"]
    assert bf["device_binds"] + bf["host_binds"] > 0
    if mode == "static":
        assert bf["dynamic_tasks"] == 0 and bf["classes"] > 0
    if mode == "dynamic":
        assert bf["classes"] == 0 and bf["dynamic_tasks"] == bf["tasks"]


def failing_bind(tripped):
    """A ``patch_allocate`` making the first bind on n0 fail once."""
    def patch(ssn):
        orig = ssn.allocate

        def allocate(task, node_name):
            if node_name == "n0" and not tripped:
                tripped.append(task.name)
                raise RuntimeError("injected transient bind failure")
            return orig(task, node_name)

        ssn.allocate = allocate

    return patch


def test_bind_failure_boundary_engine_matches():
    """bf-0's bind on n0 fails once: bf-0 falls to the host sweep with n0
    pre-recorded and lands on n1; the rest re-solve against live room, so
    bf-1 retries n0 and binds there."""
    runs = four_ways(lambda pkg: _tight_cluster(pkg, (5, 5, 5), (0, 0, 0), 2).cache,
                     patch=lambda pkg: failing_bind([]))
    port = runs[("scheduler_tpu_torch", "device")]
    assert port["statuses"]["bf-0"] == ("BINDING", "n1")
    assert port["statuses"]["bf-1"] == ("BINDING", "n0")
    bf = port["notes"]["backfill"]
    assert bf["bind_failures"] == 1 and bf["resolves"] == 1 and bf["host_binds"] == 1


def test_fast_start_fallback_engine_matches():
    """bf-1 is unplaceable: its reconstructed record names all three nodes,
    pod count first, as the host sweep's complete record does."""
    runs = four_ways(lambda pkg: _tight_cluster(pkg, (1, 1, 1), (1, 0, 1), 2).cache)
    port = runs[("scheduler_tpu_torch", "device")]
    assert port["statuses"]["bf-0"] == ("BINDING", "n1")
    assert "3 node(s) pod number exceeded" in port["fit_errors"]["bf-1"]
    assert port["notes"]["backfill"]["unplaceable"] == 1


@pytest.mark.parametrize("seed", [11, 22])
def test_mutation_trajectory_engine_matches(seed):
    """Four backfill cycles over a churning two-queue wave: every cycle's
    binds, statuses, FitErrors and evidence equal in the four runs."""
    traj = {}
    for pkg in PKGS:
        for flavor in ("host", "device"):
            b = wave_cluster(pkg, seed, 2, "mixed")
            out = []
            for cycle in range(4):
                out.append(run(pkg, b.cache, flavor))
                _mutate(b, cycle)
            traj[(pkg, flavor)] = out
    outcomes = {key: [outcome(r) for r in t] for key, t in traj.items()}
    assert outcomes[("scheduler_tpu", "device")] == outcomes[("scheduler_tpu", "host")]
    assert outcomes[("scheduler_tpu_torch", "device")] == outcomes[("scheduler_tpu", "device")]
    assert outcomes[("scheduler_tpu_torch", "device")] == outcomes[("scheduler_tpu_torch", "host")]
    for flavor in ("host", "device"):
        assert ([r["notes"] for r in traj[("scheduler_tpu_torch", flavor)]]
                == [r["notes"] for r in traj[("scheduler_tpu", flavor)]])


def wave_cache(pkg, **kw):
    """``harness/backfill_wave.py``'s cluster and wave in package ``pkg``."""
    mod = importlib.import_module(
        "scheduler_tpu_torch.harness.backfill_wave" if pkg == "scheduler_tpu_torch"
        else "scheduler_tpu.harness.backfill_wave")
    return mod.seed_wave_cache(mod.BackfillWaveConfig(**kw))


def test_backfill_wave_config_engine_matches():
    """A 64-node, 600-pod ``BackfillWaveConfig`` wave (pod limit 22, 14
    running pods a node, every third pod zone-pinned, seed 0), each
    package's cluster from its own harness: 512 slots, so 88 pods are
    unplaceable, each with the host sweep's record."""
    runs = four_ways(lambda pkg: wave_cache(pkg, nodes=64, wave_pods=600))
    port = runs[("scheduler_tpu_torch", "device")]
    bf = port["notes"]["backfill"]
    assert bf["tasks"] == 600 and bf["device_binds"] == 512 and bf["unplaceable"] == 88
    assert bf["classes"] == 5 and bf["dynamic_tasks"] == 0
    assert len(port["fit_errors"]) == 88
    assert bf["predicate_calls_host"] < runs[("scheduler_tpu_torch", "host")]["notes"][
        "backfill"]["predicate_calls_host"]


# -- the exactness gate: each decline reason, word for word ---------------------------

def _pass(task, node):
    return None


def _rows(st, device=None):
    return None


DECLINES = {
    "flavor host": (None, "flavor host"),
    "predicates without static twins": (
        lambda ssn: ssn.predicate_fns.__setitem__("gang", _pass),
        "predicates without static twins: gang"),
    "unmodeled predicate plugins": (
        lambda ssn: (ssn.predicate_fns.__setitem__("nodeorder", _pass),
                     ssn.static_predicate_fns.__setitem__("nodeorder", _pass)),
        "unmodeled predicate plugins: nodeorder"),
    "unmodeled device mask builders": (
        lambda ssn: ssn.device_predicates.__setitem__("gang", _rows),
        "unmodeled device mask builders: gang"),
    "no device mask": (
        lambda ssn: ssn.device_predicates.pop("predicates"),
        "predicates plugin published no device mask"),
}

DECLINE_CONF = """
actions: "backfill"
tiers:
- plugins:
  - name: predicates
  - name: gang
  - name: nodeorder
"""


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_decline_reason_matches_jax(case):
    """Each gate of ``BackfillEngine`` declines with the JAX engine's words
    on the same session edit in both packages; the action then runs the
    host sweep and its evidence carries the reason beside the sweep's
    counters, as JAX's does."""
    edit, reason = DECLINES[case]
    flavor = "host" if case == "flavor host" else "device"
    out = {}
    for pkg in PKGS:
        conf_mod = importlib.import_module(f"{pkg}.conf")
        framework = importlib.import_module(f"{pkg}.framework")
        backfill = importlib.import_module(f"{pkg}.ops.backfill")
        phases = importlib.import_module(f"{pkg}.utils.phases")
        kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
        with env_flag(FLAG[pkg], flavor):
            phases.begin()
            ssn = framework.open_session(wave_cluster(pkg, 7, 2).cache,
                                         conf_mod.parse_scheduler_conf(DECLINE_CONF).tiers, **kw)
            if edit is not None:
                edit(ssn)
            engine = backfill.BackfillEngine(ssn)
            stats = engine.stats()
            framework.get_action("backfill").execute(ssn)
            binds = {t.name: t.node_name for job in ssn.jobs.values()
                     for t in job.tasks.values()}
            framework.close_session(ssn)
            note = phases.take_notes().get("backfill")
            phases.end()
        out[pkg] = (stats, note, binds)
    assert out["scheduler_tpu_torch"] == out["scheduler_tpu"]
    stats, note, _ = out["scheduler_tpu_torch"]
    assert stats == {"flavor": flavor, "engaged": False, "reason": reason, "lp_noop": False}
    assert note["reason"] == reason and note["predicate_calls_host"] > 0


# -- the engine's numpy parts against the JAX package's ---------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_solve_runs_matches_jax(seed):
    """The masked-capacity water-fill on seeded rows, room and run counts:
    takes and placed equal, exactly."""
    from scheduler_tpu.ops.backfill import _solve_runs as jax_solve
    from scheduler_tpu_torch.ops.backfill import _solve_runs

    rng = np.random.default_rng(seed)
    r_n, n = int(rng.integers(1, 12)), int(rng.integers(1, 40))
    rows = rng.random((r_n, n)) < 0.6
    room = rng.integers(0, 5, size=n)
    counts = rng.integers(0, 30, size=r_n)
    takes, placed = _solve_runs(rows, room, counts)
    want_takes, want_placed = jax_solve(rows, room, counts)
    assert takes.dtype == want_takes.dtype and placed.dtype == want_placed.dtype
    np.testing.assert_array_equal(takes, want_takes)
    np.testing.assert_array_equal(placed, want_placed)
    assert (takes.sum(axis=0) <= room).all()


@pytest.mark.parametrize("seed", range(3))
def test_derive_classes_matches_jax(seed):
    from scheduler_tpu.ops.sig_compress import derive_classes as jax_derive
    from scheduler_tpu_torch.ops.sig_compress import derive_classes

    rng = np.random.default_rng(seed)
    t = int(rng.integers(1, 400))
    args = (rng.integers(0, 4, size=t).astype(np.int64),
            rng.integers(0, 6, size=t).astype(np.int32),
            rng.integers(0, 3, size=t).astype(np.int32),
            rng.integers(-2, 3, size=t).astype(np.int32))
    for static in (args[1], None):
        got = derive_classes(args[0], static, args[2], args[3])
        want = jax_derive(args[0], static, args[2], args[3])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


class _Affinity:
    """A value with a stable ``repr``, standing in for a pod's affinity."""

    def __init__(self, k):
        self.k = k

    def __repr__(self):
        return f"Affinity({self.k})"


@pytest.mark.parametrize("seed", range(3))
def test_static_signature_ids_match_jax(seed):
    """Dense static-signature ids over seeded selector, toleration,
    unknown-flag and affinity columns (affinity-carrying rows keyed by
    their spec's repr), equal exactly."""
    from scheduler_tpu.ops.backfill import _static_signature_ids as jax_ids
    from scheduler_tpu_torch.ops.backfill import _static_signature_ids

    rng = np.random.default_rng(seed)
    t, l, k = int(rng.integers(1, 200)), int(rng.integers(0, 5)), int(rng.integers(0, 3))
    req_aff = rng.random(t) < (0.2 if seed else 0.0)
    cores = np.empty(t, dtype=object)
    for i in range(t):
        cores[i] = SimpleNamespace(pod=SimpleNamespace(affinity=_Affinity(int(rng.integers(0, 3)))))
    st = SimpleNamespace(tasks=SimpleNamespace(
        selector=rng.random((t, l)) < 0.3, tolerated=rng.random((t, k)) < 0.5,
        has_unknown_selector=rng.random(t) < 0.1, req_aff=req_aff,
        pref_aff=np.zeros(t, dtype=bool), cores=cores))
    got, want = _static_signature_ids(st, t), jax_ids(st, t)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["static", "mixed"])
def test_engine_snapshot_matches_jax(mode):
    """The snapshot the class engine masks: the port's columnar build of the
    static sub-population (``BackfillEngine._snapshot``, one ``(job, rows)``
    pair a same-job run) equals, column for column, the JAX package's
    object-list build of the same tasks (its ``_prepare``), on a wave whose
    host-port pods (``mixed``) cut the static tasks out of each job."""
    sts = {}
    for pkg in PKGS:
        conf_mod = importlib.import_module(f"{pkg}.conf")
        framework = importlib.import_module(f"{pkg}.framework")
        helper = importlib.import_module(f"{pkg}.utils.scheduler_helper")
        backfill = importlib.import_module(f"{pkg}.ops.backfill")
        kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
        cache = wave_cluster(pkg, 42, 2, mode, False).cache
        ssn = framework.open_session(cache, conf_mod.parse_scheduler_conf(BACKFILL_CONF).tiers,
                                     **kw)
        with env_flag(FLAG[pkg], "device"):
            engine = backfill.BackfillEngine(ssn)
        static = [(job, task) for job, task, dyn in engine._population() if not dyn]
        nodes = helper.get_node_list(ssn.nodes)
        if pkg == "scheduler_tpu":
            from scheduler_tpu.api.tensors import build_snapshot_tensors

            sts[pkg] = build_snapshot_tensors(
                nodes, list(ssn.jobs.values()), [task for _, task in static],
                sorted(ssn.queues), next(iter(ssn.nodes.values())).vocab)
        else:
            engine._nodes = nodes
            sts[pkg] = engine._snapshot(static)
        framework.close_session(ssn)
    port, ref = sts["scheduler_tpu_torch"], sts["scheduler_tpu"]
    assert port.tasks.count == ref.tasks.count > 0
    for col in ("resreq", "init_resreq", "job_idx", "priority", "creation", "best_effort",
                "selector", "has_unknown_selector", "tolerated", "req_aff", "pref_aff"):
        np.testing.assert_array_equal(getattr(port.tasks, col), getattr(ref.tasks, col))
    assert [t.name for t in port.tasks.cores] == [t.name for t in ref.tasks.cores]
    for col in ("labels", "taints", "ready", "unschedulable", "pods_limit", "task_count"):
        np.testing.assert_array_equal(getattr(port.nodes, col), getattr(ref.nodes, col))
    assert port.nodes.names == ref.nodes.names
    np.testing.assert_array_equal(port.jobs.queue_idx, ref.jobs.queue_idx)
    np.testing.assert_array_equal(port.jobs.priority, ref.jobs.priority)


# -- the engine cache: a flip of either flag keeps the resident engine -------------------

def test_flavor_flip_keeps_the_engine_cache(monkeypatch):
    """The allocate engine never reads ``SCHEDULER_TORCH_EVICT`` or
    ``SCHEDULER_TORCH_BACKFILL``, so neither is in the engine cache's key:
    per cycle of one cluster, the outcomes before any flip are the JAX
    package's, and a flip of either flag still hits, where the JAX package
    (which pins both) misses; ``_delta_compatible`` holds across a flip."""
    from tests.test_torch_engine_cache import CONF, build_cluster

    # The first cycle places a gang (the second rebuilds); then the flips.
    steps = ((), (), (), (("EVICT", "device"),), (("EVICT", "device"),),
             (("EVICT", "device"), ("BACKFILL", "device")))
    outcomes = {}
    for pkg in PKGS:
        prefix = "SCHEDULER_TPU_" if pkg == "scheduler_tpu" else "SCHEDULER_TORCH_"
        conf_mod = importlib.import_module(f"{pkg}.conf")
        framework = importlib.import_module(f"{pkg}.framework")
        phases = importlib.import_module(f"{pkg}.utils.phases")
        engine_cache = importlib.import_module(f"{pkg}.ops.engine_cache")
        kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
        engine_cache.clear()
        cache = build_cluster(pkg, 1)
        conf = conf_mod.parse_scheduler_conf(CONF)
        out = []
        for flags in steps:
            for name in ("EVICT", "BACKFILL"):
                monkeypatch.setenv(prefix + name, dict(flags).get(name, "host"))
            phases.begin()
            ssn = framework.open_session(cache, conf.tiers, **kw)
            framework.get_action("allocate").execute(ssn)
            framework.close_session(ssn)
            out.append(phases.take_notes().get("engine_cache"))
            phases.end()
        engine_cache.clear()
        outcomes[pkg] = out
    assert outcomes["scheduler_tpu_torch"][:3] == outcomes["scheduler_tpu"][:3]
    assert outcomes["scheduler_tpu"][2:] == ["hit", "miss", "hit", "miss"]
    assert outcomes["scheduler_tpu_torch"][2:] == ["hit", "hit", "hit", "hit"]

    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.ops.fused import FusedAllocator

    monkeypatch.setenv("SCHEDULER_TORCH_EVICT", "host")
    monkeypatch.setenv("SCHEDULER_TORCH_BACKFILL", "host")
    ssn = open_session(build_cluster("scheduler_tpu_torch", 1),
                       parse_scheduler_conf(CONF).tiers, device="cpu")
    eng = FusedAllocator(ssn, [j for j in ssn.jobs.values()], device="cpu")
    assert eng._delta_compatible(ssn)
    for name in ("SCHEDULER_TORCH_EVICT", "SCHEDULER_TORCH_BACKFILL"):
        monkeypatch.setenv(name, "device")
        assert eng._delta_compatible(ssn), name
        monkeypatch.setenv(name, "host")
    eng.release()
    close_session(ssn)
