"""The port's node mesh (``scheduler_tpu_torch/ops/mesh.py``) against the JAX
package's (``scheduler_tpu/ops/mesh.py``), on the CPU.

The port's mesh draws from a device list: here ``[cpu] * 8``
(``mesh.set_mesh_devices``), the counterpart of the 8 host devices that
``tests/conftest.py`` forces on the JAX side.  Held here: spec parsing and
its memo, the degrade cases (malformed, oversized, a node bucket smaller
than the mesh), ``mesh_topology`` / ``topology_key`` equal to JAX's on
``8``, ``2x4``, ``auto`` and others, ``shard_fused_args``' placement of each
operand family, and the runtime check (``utils/shardcheck.py``) clean on
staged operands and on an engine's dispatch, and tripped on planted
misplacements.  No tolerance: everything compared is discrete.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from scheduler_tpu.ops import mesh as jax_mesh
from scheduler_tpu_torch.ops import mesh as M
from scheduler_tpu_torch.ops.layout import FUSED_ARG_FAMILIES, SHARD_FAMILY_2D
from scheduler_tpu_torch.utils import shardcheck
from scheduler_tpu_torch.utils.assertions import AssertionViolation


@pytest.fixture(autouse=True)
def cpu_mesh_devices():
    """Eight CPU devices for the port's mesh; both memos cleared after."""
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual CPU devices"
    M.set_mesh_devices(["cpu"] * 8)
    yield
    M.set_mesh_devices(None)
    jax_mesh._cached_key = object()


def set_spec(monkeypatch, spec):
    """``spec`` in both packages' mesh flags, both memos cleared."""
    for name in ("SCHEDULER_TPU_MESH", "SCHEDULER_TORCH_MESH"):
        if spec is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, spec)
    jax_mesh._cached_key = object()
    M.set_mesh_devices(["cpu"] * 8)


@pytest.mark.parametrize("spec,shape", [("8", {"nodes": 8}), ("4", {"nodes": 4}),
                                        ("2x4", {"replica": 2, "nodes": 4}),
                                        ("4x2", {"replica": 4, "nodes": 2}),
                                        ("auto", {"nodes": 8})])
def test_spec_parses_and_caches(monkeypatch, spec, shape):
    set_spec(monkeypatch, spec)
    mesh = M.get_mesh()
    assert mesh is not None and mesh.shape == shape
    assert mesh.axis_names == tuple(shape)
    assert M.is_multi_host(mesh) == ("replica" in shape)
    assert mesh.devices == (torch.device("cpu"),) * mesh.size
    assert M.get_mesh() is mesh  # memoized on the spec string
    assert dict(jax_mesh.get_mesh().shape) == shape
    assert M.mesh_requested(spec) and not M.mesh_requested("1")


@pytest.mark.parametrize("spec", ["2x", "x4", "3x4", "2x3", "1024x1024", "1x1", "abc", "1",
                                  "off", "16"])
def test_degrade_cases_match_jax(monkeypatch, caplog, spec):
    """Malformed and oversized specs stay on one device (with a warning), as
    JAX's do; ``16`` over 8 devices takes the power-of-two floor, 8."""
    set_spec(monkeypatch, spec)
    with caplog.at_level(logging.WARNING):
        mesh = M.get_mesh()
    want = jax_mesh.get_mesh()
    assert (mesh is None) == (want is None)
    if want is not None:
        assert mesh.shape == dict(want.shape)
    elif spec not in ("1", "off"):
        assert "staying single-chip" in caplog.text
    assert M.parse_2d_spec(spec) == jax_mesh.parse_2d_spec(spec)


@pytest.mark.parametrize("spec", ["8", "2x4", "auto", "4", "1", "4x2", "2x2"])
def test_topology_and_key_match_jax(monkeypatch, spec):
    set_spec(monkeypatch, spec)
    assert M.mesh_topology() == jax_mesh.mesh_topology()
    assert M.topology_key() == jax_mesh.topology_key()


def test_set_mesh_devices_clears_the_memo(monkeypatch):
    set_spec(monkeypatch, "auto")
    assert M.get_mesh().size == 8
    M.set_mesh_devices(["cpu"] * 4)
    assert M.get_mesh().shape == {"nodes": 4}
    M.set_mesh_devices(["cpu"])
    assert M.get_mesh() is None


def fused_args(n=64, t=12, s=3, r=2, seed=0, static=True):
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    idle = rng.uniform(0, 8, (n, r)).astype(np.float32)
    args = (
        idle, idle * 0, rng.integers(0, 4, n).astype(np.int32),
        torch.from_numpy(idle + 1), torch.full((n,), 10, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), torch.full((r,), 0.01, dtype=f32),
        torch.from_numpy(rng.uniform(0, 1, (t, r)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 1, (t, r)).astype(np.float32)),
        torch.from_numpy(rng.uniform(size=(s, n)) > 0.3) if static
        else torch.ones((1, 1), dtype=torch.bool),
        torch.from_numpy(rng.uniform(0, 1, (s, n)).astype(np.float32)) if static
        else torch.zeros((1, 1), dtype=f32),
        np.zeros(4, np.int32), torch.zeros(3),
    )
    return args


@pytest.mark.parametrize("spec", ["8", "2x4"])
@pytest.mark.parametrize("static", [True, False])
def test_shard_fused_args_places_each_family(monkeypatch, spec, static):
    set_spec(monkeypatch, spec)
    mesh = M.get_mesh()
    args = fused_args(static=static)
    staged = M.shard_fused_args(mesh, args)
    n_local = 64 // mesh.size
    for i, (a, b) in enumerate(zip(args, staged)):
        fam = FUSED_ARG_FAMILIES[i] if i < len(FUSED_ARG_FAMILIES) else "replicated"
        if isinstance(a, np.ndarray):
            assert b is a, f"host operand {i} moved"
            continue
        if fam == "node_trailing" and not static:
            fam = "replicated"
        if fam == "replicated":
            assert isinstance(b, torch.Tensor) and b.device == mesh.first
            assert torch.equal(b, a)
            continue
        assert isinstance(b, M.Sharded)
        assert b.family == (SHARD_FAMILY_2D[fam] if "x" in spec else fam)
        assert len(b.shards) == mesh.size and b.n_local == n_local
        assert all(s.device == d for s, d in zip(b.shards, mesh.devices))
        assert torch.equal(b.full(), a)
        axis = 0 if fam == "node_major" else 1
        assert b.axis == axis
        for k, block in enumerate(b.shards):
            assert torch.equal(block, a.narrow(axis, k * n_local, n_local))
    shardcheck_env(monkeypatch)
    shardcheck.reset()
    shardcheck.check_dispatch(mesh, staged)
    shardcheck.check_result(mesh, torch.zeros(3))
    assert shardcheck.violations() == 0


def test_bucket_smaller_than_the_mesh_stays_whole(monkeypatch, caplog):
    set_spec(monkeypatch, "8")
    args = fused_args(n=4)
    with caplog.at_level(logging.WARNING):
        staged = M.shard_fused_args(M.get_mesh(), args)
    assert staged is args
    assert "smaller than the 8-chip mesh" in caplog.text


def shardcheck_env(monkeypatch):
    monkeypatch.setenv("SCHEDULER_TORCH_SHARDCHECK", "1")
    monkeypatch.setenv("PANIC_ON_ERROR", "true")


def test_shardcheck_trips_on_planted_misplacements(monkeypatch):
    set_spec(monkeypatch, "2x4")
    mesh = M.get_mesh()
    staged = list(M.shard_fused_args(mesh, fused_args()))
    shardcheck_env(monkeypatch)
    shardcheck.reset()

    def trips(args, **kw):
        with pytest.raises(AssertionViolation, match="shardcheck"):
            shardcheck.check_dispatch(mesh, args, **kw)

    # A replicated table (init_resreq) split over the nodes.
    bad = list(staged)
    bad[7] = M.Sharded.split(mesh, torch.zeros(64, 2), 0, "node_major_2d")
    trips(bad)
    # A node ledger under its 1-D family on the 2-D mesh.
    bad = list(staged)
    bad[3] = M.Sharded(mesh, staged[3].shards, 0, "node_major")
    trips(bad)
    # A shard holding the wrong rows.
    bad = list(staged)
    blocks = list(staged[4].shards)
    blocks[2] = blocks[2][:4]
    bad[4] = M.Sharded(mesh, blocks, 0, staged[4].family)
    trips(bad)
    # Blocks of another mesh.
    other = M.NodeMesh(["cpu"] * 8, {"nodes": 8})
    bad = list(staged)
    bad[5] = M.Sharded.split(other, torch.ones(64, dtype=torch.bool), 0, "node_major_2d")
    trips(bad)
    # The whole-loop kernel's operands are all replicated.
    trips(staged, families=())
    # Without a mesh nothing may be sharded; a sharded result trips too.
    with pytest.raises(AssertionViolation):
        shardcheck.check_dispatch(None, staged)
    with pytest.raises(AssertionViolation):
        shardcheck.check_result(mesh, staged[3])
    assert shardcheck.violations() == 7
    # Off, nothing is checked.
    monkeypatch.setenv("SCHEDULER_TORCH_SHARDCHECK", "0")
    shardcheck.check_dispatch(mesh, staged, families=())
    assert shardcheck.violations() == 7
    shardcheck.reset()


@pytest.mark.parametrize("spec", ["8", "2x4"])
def test_engine_dispatch_is_shardcheck_clean(monkeypatch, spec):
    """An engine on the mesh stages its loop operands by the registry (node
    families split, the rest on the first device) and its mega operands
    whole: both dispatches check clean, and the codes equal spec 1's."""
    from tests.test_torch_loop_arms import LOOP_CASES, open_port_engine

    build, conf, _ = LOOP_CASES["binpack-runs"]
    set_spec(monkeypatch, None)
    single = open_port_engine(build, conf)
    want = single.readback().copy()
    set_spec(monkeypatch, spec)
    shardcheck_env(monkeypatch)
    shardcheck.reset()
    eng = open_port_engine(build, conf)
    assert eng._mesh is M.get_mesh() and eng.use_mega
    np.testing.assert_array_equal(eng.readback(), want)
    eng.use_mega = False
    np.testing.assert_array_equal(eng.readback(), want)
    assert isinstance(eng.args[3], M.Sharded)
    assert shardcheck.violations() == 0
    stats = eng.run_stats()
    assert stats["mesh"]["devices"] == 8 and stats["mesh"]["sharded"]
    assert stats["mesh"]["loop_shards"] == 8
