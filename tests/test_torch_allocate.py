"""The port's allocate cycle end to end against the JAX package, on the CPU.

The same cluster is built in both packages (same objects, same timestamps),
one allocate action runs in each, and the outcome must be equal: binds keyed
by namespace/name (never by UID, a process-global counter), every task's
status and node, and every FitError string.  The port runs with
``device="cpu"``, where the mega kernel's wrapper runs its plain PyTorch
version.  The port's fused route is also held to its own host loop, the
reference semantics it takes for the sessions the fused route declines.
"""

import importlib
import json

import pytest

from scheduler_tpu_torch.actions import allocate as torch_allocate
from tests.test_torch_megakernel import FLAGSHIP_CONF, build_twin, config1_spec, synthetic_twin

CONFIG1_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
"""

# (fixture id, cluster builder(pkg), conf)
CLUSTERS = {
    "config1": (lambda pkg: build_twin(pkg, config1_spec()), CONFIG1_CONF),
    "synthetic-64x600": (lambda pkg: synthetic_twin(pkg, 64, 600, 10), FLAGSHIP_CONF),
    # Contended: 8 nodes cannot hold 600 pods, so gangs fail and record FitErrors.
    "synthetic-8x600": (lambda pkg: synthetic_twin(pkg, 8, 600, 10), FLAGSHIP_CONF),
}


def open_session(pkg, cache, conf_text):
    conf = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    return framework.open_session(cache, conf.parse_scheduler_conf(conf_text).tiers, **kw)


def outcome(pkg, cache, ssn):
    """Name-keyed statuses and FitErrors of the open session, then close it
    and read the binds."""
    framework = importlib.import_module(f"{pkg}.framework")
    statuses = {
        t.name: (t.status.name, t.node_name)
        for job in ssn.jobs.values() for t in job.tasks.values()
    }
    fit_errors = {
        t.name: job.nodes_fit_errors[t.uid].error()
        for job in ssn.jobs.values() for t in job.tasks.values()
        if t.uid in job.nodes_fit_errors
    }
    framework.close_session(ssn)
    return statuses, fit_errors, dict(cache.binder.binds)


def run_allocate(pkg, fixture):
    build, conf_text = CLUSTERS[fixture]
    cache = build(pkg)
    ssn = open_session(pkg, cache, conf_text)
    importlib.import_module(f"{pkg}.framework").get_action("allocate").execute(ssn)
    return outcome(pkg, cache, ssn)


@pytest.mark.parametrize("fixture", sorted(CLUSTERS))
def test_allocate_matches_jax(fixture):
    routes = dict(torch_allocate.routes)
    jax_statuses, jax_errors, jax_binds = run_allocate("scheduler_tpu", fixture)
    statuses, errors, binds = run_allocate("scheduler_tpu_torch", fixture)
    assert torch_allocate.routes["fused"] == routes["fused"] + 1
    assert torch_allocate.routes["host"] == routes["host"]
    assert binds == jax_binds
    assert statuses == jax_statuses
    assert errors == jax_errors
    assert binds
    if fixture == "synthetic-8x600":
        assert errors, "the contended cluster must record FitErrors"


@pytest.mark.parametrize("fixture", sorted(CLUSTERS))
def test_fused_route_matches_host_loop(fixture):
    """The port's fused route (mega kernel, plain version on the CPU) and its
    host loop place identically; the host loop records per-node FitErrors
    where the fused route records one, so their task sets are compared."""
    statuses, errors, binds = run_allocate("scheduler_tpu_torch", fixture)
    build, conf_text = CLUSTERS[fixture]
    cache = build("scheduler_tpu_torch")
    ssn = open_session("scheduler_tpu_torch", cache, conf_text)
    routes = dict(torch_allocate.routes)
    torch_allocate.AllocateAction()._heap_loop(ssn, torch_allocate.collect_candidates(ssn))
    assert torch_allocate.routes["host"] == routes["host"] + 1
    host_statuses, host_errors, host_binds = outcome("scheduler_tpu_torch", cache, ssn)
    assert binds == host_binds
    assert statuses == host_statuses
    assert set(errors) == set(host_errors)


def test_scheduler_run_once_matches_jax(tmp_path):
    """``Scheduler.run_once`` in both packages, on BASELINE config 1."""
    from scheduler_tpu.scheduler import Scheduler as JaxScheduler
    from scheduler_tpu_torch.scheduler import Scheduler

    conf = tmp_path / "conf.yaml"
    conf.write_text(CONFIG1_CONF)
    jax_cache = build_twin("scheduler_tpu", config1_spec())
    JaxScheduler(jax_cache, scheduler_conf=str(conf)).run_once()
    cache = build_twin("scheduler_tpu_torch", config1_spec())
    Scheduler(cache, scheduler_conf=str(conf), device="cpu").run_once()
    assert dict(cache.binder.binds) == dict(jax_cache.binder.binds)
    assert set(cache.binder.binds) == {"default/qj-0", "default/qj-1", "default/qj-2"}


def test_load_cluster_state_seeds_both_packages(tmp_path):
    """One ``{queues, nodes, podGroups, pods}`` JSON file seeds both packages'
    caches (``cli.load_cluster_state``): ``deploy/example-cluster.json``, its
    gang admitted (phase Inqueue: the port has no enqueue action), plus a
    second gang that no longer fits.  One allocate cycle binds the same."""
    from pathlib import Path

    from scheduler_tpu.cli import load_cluster_state as jax_load
    from scheduler_tpu_torch.cli import load_cluster_state

    example = Path(__file__).resolve().parent.parent / "deploy" / "example-cluster.json"
    state = json.loads(example.read_text())
    for pg in state["podGroups"]:
        pg["phase"] = "Inqueue"
    state["podGroups"].append({"name": "big", "queue": "default", "minMember": 4,
                               "phase": "Inqueue"})
    state["pods"] += [{"name": f"big-{t}", "group": "big", "priority": 1,
                       "containers": [{"cpu": 2000, "memory": 2**30}]} for t in range(4)]
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(state))
    outcomes = []
    for pkg, load in (("scheduler_tpu", jax_load), ("scheduler_tpu_torch", load_cluster_state)):
        vocab = importlib.import_module(f"{pkg}.api.vocab")
        cache = importlib.import_module(f"{pkg}.cache.cache").SchedulerCache(
            vocab=vocab.ResourceVocabulary(), async_io=False)
        cache.run()
        load(cache, str(path))
        ssn = open_session(pkg, cache, FLAGSHIP_CONF)
        importlib.import_module(f"{pkg}.framework").get_action("allocate").execute(ssn)
        outcomes.append(outcome(pkg, cache, ssn))
    assert outcomes[0] == outcomes[1]
    statuses, errors, binds = outcomes[1]
    assert binds and errors, "one gang binds, the other records a FitError"


def test_scheduler_traces_its_first_cycles_with_torch_profiler(tmp_path):
    from scheduler_tpu_torch.scheduler import Scheduler

    conf = tmp_path / "conf.yaml"
    conf.write_text(CONFIG1_CONF)
    cache = build_twin("scheduler_tpu_torch", config1_spec())
    sched = Scheduler(cache, scheduler_conf=str(conf), profile_dir=str(tmp_path / "prof"),
                      device="cpu")
    sched.run_once()
    trace = json.loads((tmp_path / "prof" / "cycle0000.json").read_text())
    assert trace["traceEvents"]
    assert len(cache.binder.binds) == 3
