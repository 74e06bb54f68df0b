"""The fused engine on a node mesh, the port against the JAX package, on the CPU.

The JAX package runs under ``SCHEDULER_TPU_MESH`` over the 8 host devices
``tests/conftest.py`` forces; the port under ``SCHEDULER_TORCH_MESH`` over
eight CPU devices (``mesh.set_mesh_devices``).  On specs ``8`` and ``2x4``,
with no tolerance (codes, binds and statuses equal):

* the production allocate action: the port's binds equal the JAX
  package's at the same spec and the port's own at spec 1;
* each arm forced on the same engine: the whole-loop kernel in mesh mode,
  K1 on every shard (``use_mega = False``), and the XLA arm's shard mode on
  a releasing session and on a score-bound one; each against the JAX
  engine on the mesh and the port's spec-1 engine;
* the LP flavor: codes equal to the JAX package's mesh run and to spec 1
  (as ``tests/test_lp_place.py:399`` holds the JAX package);
* the engine cache keyed on the topology: hits on the same topology, a
  miss on a changed one, placements unchanged.

The eviction pick and the backfill fill on the mesh are held in
``tests/test_torch_mesh_flavors.py``.

Proportion's water-fill runs on the host on the JAX side
(``SCHEDULER_TPU_QFAIR=host``: its device flavor imports
``jax.experimental.enable_x64``, which this jax lacks); the port's device
water-fill is bitwise the host one.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import lp_spec, spec_cluster
from scheduler_tpu.ops import mesh as jax_mesh
from scheduler_tpu_torch.ops import mesh as M
from scheduler_tpu_torch.ops import step_kernel as sk
from scheduler_tpu_torch.ops import xla_step
from tests.test_torch_loop_arms import templates
from tests.test_torch_megakernel import FLAGSHIP_CONF, SCORE_BOUND_CONF
from tests.test_torch_releasing import PROPORTION_CONF, open_in, releasing_twin

JAX, PORT = "scheduler_tpu", "scheduler_tpu_torch"
SPECS = ["8", "2x4"]


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual CPU devices"
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "host")
    M.set_mesh_devices(["cpu"] * 8)
    yield
    M.set_mesh_devices(None)
    jax_mesh._cached_key = object()


def set_spec(monkeypatch, spec):
    for name in ("SCHEDULER_TPU_MESH", "SCHEDULER_TORCH_MESH"):
        if spec is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, spec)
    jax_mesh._cached_key = object()
    M.set_mesh_devices(["cpu"] * 8)


def engine(pkg, cache, conf):
    ssn = open_in(pkg, cache, conf)
    acts = importlib.import_module(f"{pkg}.actions.allocate")
    fused = importlib.import_module(f"{pkg}.ops.fused")
    kw = {"device": "cpu"} if pkg == PORT else {}
    return fused.FusedAllocator(ssn, acts.collect_candidates(ssn), **kw)


def codes_of(eng, use_mega):
    eng.use_mega = use_mega
    out = eng._execute() if hasattr(eng, "_execute") else eng.readback()
    return np.asarray(out).copy()[:eng.flat_count]


# case -> (cluster builder, conf, port arm on the loop); where the mega gate
# admits the session, its mesh mode runs first.
ARM_CASES = {
    "cursor": (lambda pkg: templates(pkg, 16, 24, 4), FLAGSHIP_CONF, "step"),
    "score-bound": (lambda pkg: templates(pkg, 16, 24, 4), SCORE_BOUND_CONF, "xla"),
    "releasing": (lambda pkg: releasing_twin(pkg, 1), PROPORTION_CONF, "xla"),
}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", sorted(ARM_CASES))
def test_each_arm_matches_jax_and_one_device(monkeypatch, spec, case):
    build, conf, arm = ARM_CASES[case]
    set_spec(monkeypatch, None)
    single = engine(PORT, build(PORT), conf)
    want = codes_of(single, False)
    assert ((want >= 0) | (want <= -3)).any()
    set_spec(monkeypatch, spec)
    port = engine(PORT, build(PORT), conf)
    ref = engine(JAX, build(JAX), conf)
    assert port._mesh is M.get_mesh() and port._mesh.size == 8
    assert ref._mesh is not None
    assert port.use_mega == ref.use_mega
    if port.use_mega:
        np.testing.assert_array_equal(codes_of(port, True), want)
        np.testing.assert_array_equal(codes_of(ref, True), want)
    k1_before, xla_before = sk.launches, xla_step.shard_launches
    got = codes_of(port, False)
    assert port.engine == arm and port.step_kernel == ref.step_kernel
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codes_of(ref, False), want)
    stats = port.run_stats()
    assert stats["mesh"]["sharded"] and stats["mesh"]["loop_shards"] == 8
    assert (sk.launches, xla_step.shard_launches) == (k1_before, xla_before), \
        "the CPU arms launch no kernel"
    if case == "releasing":
        assert (got <= -3).any(), "some task must be pipelined"


@pytest.mark.parametrize("spec", SPECS)
def test_production_allocate_binds_match(monkeypatch, spec):
    """The allocate action under the mesh flag binds as the JAX package's
    does at the same spec, and as the port does at spec 1."""

    def binds(pkg):
        cache = templates(pkg, 16, 24, 4)
        ssn = open_in(pkg, cache, FLAGSHIP_CONF)
        framework = importlib.import_module(f"{pkg}.framework")
        framework.get_action("allocate").execute(ssn)
        framework.close_session(ssn)
        return dict(cache.binder.binds)

    set_spec(monkeypatch, None)
    single = binds(PORT)
    set_spec(monkeypatch, spec)
    assert binds(PORT) == binds(JAX) == single
    assert len(single) > 0


@pytest.mark.parametrize("spec", SPECS)
def test_lp_codes_match(monkeypatch, spec):
    from tests.test_torch_lp_place import BINPACK_CONF, _assert_feasible

    monkeypatch.setenv("SCHEDULER_TPU_ALLOCATOR", "lp")
    monkeypatch.setenv("SCHEDULER_TORCH_ALLOCATOR", "lp")
    torch.set_num_threads(1)
    spec_c = lp_spec(n_nodes=16, n_gangs=4, gang_size=5)

    def run(pkg):
        eng = engine(pkg, spec_cluster(spec_c, pkg), BINPACK_CONF)
        assert eng.use_lp, eng.lp_reason
        return eng, codes_of(eng, eng.use_mega)

    set_spec(monkeypatch, None)
    _, single = run(PORT)
    set_spec(monkeypatch, spec)
    eng, got = run(PORT)
    ref, want = run(JAX)
    assert eng._lp_mesh is not None and ref._lp_mesh is not None
    _assert_feasible(eng, got)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)
    assert eng.run_stats()["lp"]["binds"] == int((got >= 0).sum()) > 0


def test_engine_cache_hits_on_a_topology_and_misses_on_a_change(monkeypatch):
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, get_action, open_session
    from scheduler_tpu_torch.ops import engine_cache
    from tests.test_torch_engine_cache import CONF, build_cluster

    monkeypatch.setenv("SCHEDULER_TORCH_ENGINE_CACHE", "1")
    engine_cache.clear()
    engine_cache.reset_counters()
    cache = build_cluster(PORT, 2)
    conf = parse_scheduler_conf(CONF)

    def cycle():
        ssn = open_session(cache, conf.tiers, device="cpu")
        get_action("allocate").execute(ssn)
        close_session(ssn)
        return dict(cache.binder.binds)

    set_spec(monkeypatch, "2x4")
    first = cycle()
    cycle()
    cycle()
    on_2x4 = engine_cache.reset_counters()
    assert on_2x4["hits"] >= 1, on_2x4
    set_spec(monkeypatch, "8")
    assert cycle() == first
    on_8 = engine_cache.reset_counters()
    assert on_8["misses"] == 1 and on_8["hits"] == 0, on_8
    set_spec(monkeypatch, "2x4")
    assert cycle() == first
    back = engine_cache.reset_counters()
    assert back["misses"] == 0, back
    engine_cache.clear()


def test_shape_key_embeds_the_topology(monkeypatch):
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.ops import engine_cache
    from tests.test_torch_engine_cache import CONF, build_cluster

    cache = build_cluster(PORT, 1)
    ssn = open_session(cache, parse_scheduler_conf(CONF).tiers, device="cpu")
    try:
        keys = []
        for spec in ("2x4", "4x2", "8", None):
            set_spec(monkeypatch, spec)
            keys.append(engine_cache.shape_key(ssn))
        assert None not in keys and len(set(keys)) == 4, keys
    finally:
        close_session(ssn)


@pytest.mark.parametrize("spec", SPECS)
def test_interop_carries_the_jax_mesh(monkeypatch, spec):
    """``interop.fused_operands_from_numpy`` on the JAX engine's mesh operands
    and static arguments: the port's loop on a mesh of the same shape over
    the CPU, its node operands split, gives the JAX loop's codes."""
    from scheduler_tpu.ops.fused import fused_allocate as jax_fused_allocate
    from scheduler_tpu_torch.interop import fused_operands_from_numpy
    from scheduler_tpu_torch.ops import fused as fused_mod

    set_spec(monkeypatch, spec)
    ref = engine(JAX, templates(JAX, 16, 24, 4), FLAGSHIP_CONF)
    ref.use_mega = False
    kw = ref._allocate_kw()
    assert kw["mesh"] is not None
    want = np.asarray(jax_fused_allocate(*ref.args, **kw))
    args, port_kw = fused_operands_from_numpy([np.asarray(a) for a in ref.args], kw, "cpu")
    mesh = port_kw["mesh"]
    assert mesh.shape == dict(kw["mesh"].shape) and isinstance(args[3], M.Sharded)
    codes, stats = fused_mod.fused_allocate(*args, **port_kw)
    assert stats["shards"] == 8 and stats["arm"] == ("step_kernel" if kw["step_kernel"] else "xla")
    np.testing.assert_array_equal(codes.numpy(), want)
