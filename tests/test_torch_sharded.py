"""The port's selection over node shards (``scheduler_tpu_torch/ops/sharded.py``)
against the JAX package's ``shard_map`` versions (``scheduler_tpu/ops/sharded.py``)
on the CPU: the JAX side on the 8 host devices ``tests/conftest.py`` forces,
the port on a mesh of eight CPU devices, the same inputs from numpy seeds.

* ``two_level_winner`` and its capacity and queue variants on planted
  cross-shard ties, on the 1-D and the 2-D (replica-major) mesh: the lowest
  shard wins a tie, so the lowest global index;
* ``merge_row_logsumexp`` on the same packs: ``m``, ``pref`` and
  ``upd_max`` equal, ``s`` within 1e-6 relative (the port adds the shards'
  terms in shard order; XLA's reduction order is its own);
* ``sharded_place_scan`` (seeds 0-2, both weight sets of
  ``tests/test_sharded.py``, both mesh shapes) and ``sharded_selector_mask``:
  every output equal, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scheduler_tpu.ops import sharded as jsh
from scheduler_tpu.ops.placement import _place_scan as jax_place_scan
from scheduler_tpu_torch.ops import mesh as M
from scheduler_tpu_torch.ops import sharded as psh
from scheduler_tpu_torch.ops.layout import LP_PACK
from scheduler_tpu_torch.ops.placement import _place_scan as port_place_scan
from tests.test_sharded import random_problem

SCAN_KEYS = ("idle", "releasing", "task_count", "allocatable", "pods_limit", "mins",
             "init_resreq", "resreq", "static_mask", "static_score", "valid")


def meshes(kind):
    """(JAX mesh, port mesh) of eight devices: ``1d`` (nodes,), ``2d`` 2x4."""
    devices = jax.devices()
    assert len(devices) >= 8, "conftest must force 8 virtual CPU devices"
    if kind == "1d":
        return (Mesh(np.array(devices[:8]), (jsh.NODE_AXIS,)),
                M.NodeMesh(["cpu"] * 8, {"nodes": 8}))
    return (Mesh(np.array(devices[:8]).reshape(2, 4), (jsh.REPLICA_AXIS, jsh.NODE_AXIS)),
            M.NodeMesh(["cpu"] * 8, {"replica": 2, "nodes": 4}))


def jax_winner(jmesh, cand):
    """JAX's ``two_level_winner_with_queue`` over per-shard candidate rows
    ``cand`` [D, 5] (shard k's row on the device of linear index k)."""
    axes = jsh.node_shard_axes(jmesh)

    def body(c):
        c = c[0]
        return jnp.stack([x.astype(jnp.float32) for x in jsh.two_level_winner_with_queue(
            c[0], c[1].astype(jnp.int32), c[2], c[3], c[4], axis=axes)])

    f = jsh.shard_map(body, mesh=jmesh, in_specs=(P(axes),), out_specs=P(),
                      check_vma=False)
    arr = jax.device_put(jnp.asarray(cand, dtype=jnp.float32), NamedSharding(jmesh, P(axes)))
    return np.asarray(f(arr))


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("case", ["all-tie", "tie-later-shards", "one-best", "all-infeasible",
                                  "random"])
def test_two_level_winner_matches_jax(kind, case):
    jmesh, pmesh = meshes(kind)
    rng = np.random.default_rng(7)
    d, n_local = 8, 16
    scores = {
        "all-tie": np.full(d, 3.5),
        "tie-later-shards": np.array([1.0, 2.0, 2.0, 5.0, 1.0, 5.0, 5.0, 0.5]),
        "one-best": np.array([1.0, 2.0, 2.0, 1.0, 1.0, 9.0, 5.0, 0.5]),
        "all-infeasible": np.full(d, -np.inf),
        "random": rng.integers(0, 3, d).astype(np.float64),
    }[case].astype(np.float32)
    local = rng.integers(0, n_local, d)
    cand = np.stack([scores, local + np.arange(d) * n_local, rng.integers(1, 128, d),
                     rng.integers(0, 110, d), rng.integers(0, 5, d)], axis=1)
    rows = [(float(c[0]), int(c[1]), int(c[2]), int(c[3]), int(c[4])) for c in cand]
    got = psh.two_level_winner_with_queue(rows)
    want = jax_winner(jmesh, cand)
    assert (np.float32(got[0]), *got[1:]) == (np.float32(want[0]), *[int(x) for x in want[1:]])
    k = int(np.flatnonzero(scores == scores.max())[0])
    assert got[1] == int(cand[k, 1]), "a tie goes to the lowest shard"
    assert psh.two_level_winner_with_capacity(rows) == got[:4]
    assert psh.two_level_winner([r[:2] for r in rows]) == rows[k][:2]
    if kind == "2d":
        assert psh.shard_linear_index(pmesh, 1, 2) == 6
        assert psh.node_shard_axes(pmesh) == ("replica", "nodes")
    else:
        assert psh.shard_linear_index(pmesh, 0, 5) == 5


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_row_logsumexp_matches_jax(kind, seed):
    jmesh, _ = meshes(kind)
    axes = jsh.node_shard_axes(jmesh)
    rng = np.random.default_rng(seed)
    t = 40
    packs = np.zeros((8, 4, t), dtype=np.float32)
    packs[:, LP_PACK.MAX] = rng.integers(-3, 3, (8, t)).astype(np.float32) * 0.5
    packs[:, LP_PACK.MAX, :5] = -1e9  # rows with no feasible node anywhere
    packs[:, LP_PACK.SUM] = rng.uniform(1.0, 20.0, (8, t)).astype(np.float32)
    packs[:, LP_PACK.ARGMAX] = (rng.integers(0, 16, (8, t)) + 16 * np.arange(8)[:, None])
    packs[:, LP_PACK.UPD] = rng.uniform(0, 1, 8).astype(np.float32)[:, None]

    def body(p):
        m, s, pref, upd = jsh.merge_row_logsumexp(p[0], axes)
        return m, s, pref, upd

    f = jsh.shard_map(body, mesh=jmesh, in_specs=(P(axes),), out_specs=(P(), P(), P(), P()),
                      check_vma=False)
    want = [np.asarray(x) for x in f(jax.device_put(jnp.asarray(packs),
                                                    NamedSharding(jmesh, P(axes))))]
    got = [x.numpy() for x in psh.merge_row_logsumexp(torch.from_numpy(packs))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weights", [(0.0, 0.0, 0.0), (1.0, 1.0, 0.0)])
def test_sharded_place_scan_matches_jax(kind, seed, weights):
    jmesh, pmesh = meshes(kind)
    p = random_problem(np.random.default_rng(seed))
    deficit = 100  # never fires: the scan runs every task
    want = jsh.sharded_place_scan(*[jnp.asarray(p[k]) for k in SCAN_KEYS],
                                  jnp.asarray(deficit, dtype=jnp.int32), mesh=jmesh,
                                  weights=weights, enforce_pod_count=True)
    single = jax_place_scan(*[jnp.asarray(p[k]) for k in SCAN_KEYS],
                            jnp.asarray(deficit, dtype=jnp.int32), weights, True)
    got = psh.sharded_place_scan(*[torch.from_numpy(np.asarray(p[k])) for k in SCAN_KEYS],
                                 deficit, mesh=pmesh, weights=weights, enforce_pod_count=True)
    plain = port_place_scan(*[torch.from_numpy(np.asarray(p[k])) for k in SCAN_KEYS],
                            deficit, weights, True)
    names = ("idle", "releasing", "task_count", "chosen", "pipelined", "failed")
    for name, g, w, s, pl in zip(names, got, want, single, plain):
        g = (g.full() if isinstance(g, M.Sharded) else g).numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g, np.asarray(s), err_msg=name)
        np.testing.assert_array_equal(g, pl.numpy(), err_msg=name)
    assert (got[3].numpy() >= 0).any()
    assert isinstance(got[0], M.Sharded) and len(got[0].shards) == 8


def test_sharded_place_scan_cross_shard_tie_goes_to_the_lowest_index():
    """Nodes identical across shards: every placement lands on the lowest
    global row that still fits, as on one device."""
    jmesh, pmesh = meshes("2d")
    p = random_problem(np.random.default_rng(0))
    p["idle"][:] = 8.0
    p["releasing"][:] = 0.0
    p["allocatable"][:] = 12.0
    p["task_count"][:] = 0
    p["static_mask"][:] = True
    p["static_score"][:] = 0.5
    got = psh.sharded_place_scan(*[torch.from_numpy(np.asarray(p[k])) for k in SCAN_KEYS], 100,
                                 mesh=pmesh, weights=(1.0, 1.0, 0.0), enforce_pod_count=True)
    want = jsh.sharded_place_scan(*[jnp.asarray(p[k]) for k in SCAN_KEYS],
                                  jnp.asarray(100, dtype=jnp.int32), mesh=jmesh,
                                  weights=(1.0, 1.0, 0.0), enforce_pod_count=True)
    chosen = got[3].numpy()
    np.testing.assert_array_equal(chosen, np.asarray(want[3]))
    placed = chosen[chosen >= 0]
    assert placed.size and placed[0] == 0


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_sharded_selector_mask_matches_jax(kind):
    jmesh, pmesh = meshes(kind)
    rng = np.random.default_rng(3)
    sel = rng.uniform(size=(12, 6)) > 0.7
    labels = rng.uniform(size=(64, 6)) > 0.4
    want = np.asarray(jsh.sharded_selector_mask(jnp.asarray(sel), jnp.asarray(labels),
                                                mesh=jmesh))
    got = psh.sharded_selector_mask(torch.from_numpy(sel), torch.from_numpy(labels), mesh=pmesh)
    assert isinstance(got, M.Sharded) and got.axis == 1 and got.n_local == 8
    np.testing.assert_array_equal(got.full().numpy(), want)
    assert want.any() and not want.all()
