"""The port's per-pop engine (``ops/allocator.py::DeviceAllocator``) and
allocate's device route against the JAX package, on the CPU.

With the fused engine's static-row limit at 1 byte in both packages
(``SCHEDULER_TPU_FUSED_STATIC_LIMIT`` and the port's
``SCHEDULER_TORCH_FUSED_STATIC_LIMIT``), every session with static rows
declines the fused gate; where every plugin is device-capable, both
packages build a ``DeviceAllocator`` and run the host heaps with one scan a
job pop (the port: ``place_scan``'s plain version on CPU tensors).  The
clusters are ``tests/test_torch_allocate.py``'s twins (same objects, same
timestamps): the port must build the engine exactly where the JAX package
does, and one allocate action must give equal statuses, FitErrors and
binds.  The device route is also held to the port's own host loop (the
engine-parity contract of ``tests/test_allocate.py``), and the gate, the
flag, the engine's owned node state and its static tensors are pinned.
The JAX package runs proportion's host water-fill
(``SCHEDULER_TPU_QFAIR=host``).
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

import scheduler_tpu.ops.allocator as jax_allocator
import scheduler_tpu_torch.ops.allocator as torch_allocator_mod
from scheduler_tpu_torch.actions import allocate as torch_allocate
from scheduler_tpu_torch.ops import engine_cache, transfer_cache
from tests.test_torch_allocate import CLUSTERS, open_session, outcome

# Fixtures whose sessions have static rows and only device-capable plugins:
# with the limit at 1 byte they take the device route in both packages.
DEVICE_FIXTURES = ("config2-64x600", "predicates", "dynamic", "config5-75x50",
                   "config2-default-tiers")


@pytest.fixture(autouse=True)
def _limits(monkeypatch):
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "host")
    monkeypatch.setenv("SCHEDULER_TPU_FUSED_STATIC_LIMIT", "1")
    monkeypatch.setenv("SCHEDULER_TORCH_FUSED_STATIC_LIMIT", "1")


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


def _spy_builds(monkeypatch, cls):
    """Count the engines ``cls`` builds."""
    built = []
    orig = cls.__init__

    def init(self, *args, **kwargs):
        built.append(self)
        orig(self, *args, **kwargs)

    monkeypatch.setattr(cls, "__init__", init)
    return built


def _allocate(pkg, fixture):
    build, conf_text = CLUSTERS[fixture]
    cache = build(pkg)
    ssn = open_session(pkg, cache, conf_text)
    importlib.import_module(f"{pkg}.framework").get_action("allocate").execute(ssn)
    return outcome(pkg, cache, ssn)


@pytest.mark.parametrize("fixture", sorted(CLUSTERS))
def test_device_route_matches_jax(monkeypatch, fixture):
    jax_built = _spy_builds(monkeypatch, jax_allocator.DeviceAllocator)
    port_built = _spy_builds(monkeypatch, torch_allocator_mod.DeviceAllocator)
    routes = dict(torch_allocate.routes)
    jax_out = _allocate("scheduler_tpu", fixture)
    port_out = _allocate("scheduler_tpu_torch", fixture)
    assert len(port_built) == len(jax_built) == (fixture in DEVICE_FIXTURES)
    assert torch_allocate.routes["device"] == routes["device"] + len(port_built)
    statuses, errors, binds = port_out
    assert binds == jax_out[2]
    assert statuses == jax_out[0]
    assert errors == jax_out[1]
    assert binds
    if port_built:
        engine = port_built[0]
        assert engine.stats["pops"] > 0 and engine.stats["tasks_scanned"] > 0
        assert torch_allocate.routes["fused"] == routes["fused"]


@pytest.mark.parametrize("fixture", sorted(set(DEVICE_FIXTURES) - {"dynamic"}))
def test_device_route_matches_host_loop(fixture):
    """The device route and the port's host loop place identically; the host
    loop records per-node FitErrors where the scan records one, so their
    task sets are compared."""
    statuses, errors, binds = _allocate("scheduler_tpu_torch", fixture)
    build, conf_text = CLUSTERS[fixture]
    cache = build("scheduler_tpu_torch")
    ssn = open_session("scheduler_tpu_torch", cache, conf_text)
    torch_allocate.AllocateAction()._heap_loop(ssn, torch_allocate.collect_candidates(ssn))
    host_statuses, host_errors, host_binds = outcome("scheduler_tpu_torch", cache, ssn)
    assert binds == host_binds
    assert statuses == host_statuses
    assert set(errors) == set(host_errors)


def test_static_limit_flag_moves_the_gate(monkeypatch):
    """``SCHEDULER_TORCH_FUSED_STATIC_LIMIT`` (bytes, default 160 MiB): the
    fused gate takes the config-2 twin under the default and declines it at
    1 byte, as the JAX twin flag does; the engine cache keys on it."""
    from scheduler_tpu.ops.fused import FusedAllocator as JaxFused
    from scheduler_tpu_torch.api.tensors import bucket
    from scheduler_tpu_torch.ops.fused import FusedAllocator, fused_static_limit

    build, conf_text = CLUSTERS["config2-64x600"]
    need = 5 * bucket(600) * bucket(64)  # the twin's static rows, 5 bytes an element
    for limit, fused in (("1", False), (None, True), (str(need), True),
                         (str(need - 1), False)):
        for name in ("SCHEDULER_TPU_FUSED_STATIC_LIMIT", "SCHEDULER_TORCH_FUSED_STATIC_LIMIT"):
            if limit is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, limit)
        assert fused_static_limit() == (160 * 1024 * 1024 if limit is None else int(limit))
        port = open_session("scheduler_tpu_torch", build("scheduler_tpu_torch"), conf_text)
        jax = open_session("scheduler_tpu", build("scheduler_tpu"), conf_text)
        assert FusedAllocator.supported(port) == JaxFused.supported(jax) == fused
        assert torch_allocator_mod.DeviceAllocator.supported(port)
    assert "SCHEDULER_TORCH_FUSED_STATIC_LIMIT" in engine_cache._ENV_KEYS


def test_engine_owns_the_node_state_it_writes():
    """The node tensors come through the transfer cache, whose residents
    may be shared: the engine writes its own copies, so a second engine
    built from the same cluster state starts from the untouched rows, and
    both place alike."""
    transfer_cache.clear()
    results = []
    for _ in range(2):
        build, conf_text = CLUSTERS["config2-64x600"]
        cache = build("scheduler_tpu_torch")
        ssn = open_session("scheduler_tpu_torch", cache, conf_text)
        engine = torch_allocator_mod.DeviceAllocator(
            ssn, torch_allocate.collect_candidates(ssn))
        idle0 = engine.state.idle.clone()
        resident = transfer_cache.to_device(engine.state.idle.numpy(), np.float32, "cpu")
        torch_allocate.AllocateAction()._heap_loop(
            ssn, torch_allocate.collect_candidates(ssn), engine)
        assert not torch.equal(engine.state.idle, idle0)  # the scan wrote its copy
        assert engine.state.idle.data_ptr() != resident.data_ptr()
        results.append(outcome("scheduler_tpu_torch", cache, ssn))
    assert results[0] == results[1]
    transfer_cache.clear()


def test_static_tensors_match_jax_host_build():
    """``build_static_tensors`` on the device equals the JAX package's host
    build: the mask bit for bit (pad nodes infeasible), and the score rows
    where a scorer contributes (preferred node affinity); None where none
    does (the JAX rows are then all zero)."""
    from scheduler_tpu.actions.allocate import collect_candidates
    from scheduler_tpu.api.tensors import build_snapshot_tensors
    from scheduler_tpu.utils.scheduler_helper import task_sort_key as jax_sort_key

    for fixture, has_score in (("predicates", True), ("config2-64x600", False)):
        build, conf_text = CLUSTERS[fixture]
        ssn = open_session("scheduler_tpu_torch", build("scheduler_tpu_torch"), conf_text)
        engine = torch_allocator_mod.DeviceAllocator(
            ssn, torch_allocate.collect_candidates(ssn))
        jssn = open_session("scheduler_tpu", build("scheduler_tpu"), conf_text)
        jobs = collect_candidates(jssn)
        key = jax_sort_key(jssn)
        tasks = [t for job in jobs for t in jax_allocator.collect_pending(job, key)]
        st = build_snapshot_tensors(sorted(jssn.nodes.values(), key=lambda n: n.name), jobs,
                                    tasks, sorted(jssn.queues), next(iter(
                                        jssn.nodes.values())).vocab)
        mask, score = jax_allocator.build_static_tensors(jssn, st, engine.n_bucket)
        assert [t.name for t in engine.tasks] == [t.name for t in tasks]
        np.testing.assert_array_equal(engine.static_mask.numpy(), mask)
        assert not mask[:, engine.n_nodes:].any()
        if has_score:
            np.testing.assert_array_equal(engine.static_score.numpy(), score)
            assert score.any()
        else:
            assert engine.static_score is None and not score.any()


def test_ready_deficit_follows_gang():
    """gang enabled: min_available - ready; gang's job_ready off or no
    job_ready plugin: 0 (the pop places one task); another job_ready
    plugin: None (no engine run for the job)."""
    build, conf_text = CLUSTERS["config2-64x600"]
    ssn = open_session("scheduler_tpu_torch", build("scheduler_tpu_torch"), conf_text)
    engine = torch_allocator_mod.DeviceAllocator(ssn, torch_allocate.collect_candidates(ssn))
    job = next(iter(ssn.jobs.values()))
    assert engine.ready_deficit(job) == job.min_available - job.ready_task_num()
    saved = dict(ssn.job_ready_fns)
    ssn.job_ready_fns.clear()
    assert engine.ready_deficit(job) == 0
    ssn.job_ready_fns.update(saved, other=lambda j: True)
    assert engine.ready_deficit(job) is None
    assert engine.place_job(job, list(job.tasks.values())) is None
