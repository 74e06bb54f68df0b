"""The eviction pick and the backfill fill on a node mesh, the port against
the JAX package's mesh twins, on the CPU.

The JAX package runs under ``SCHEDULER_TPU_MESH`` over the 8 host devices
``tests/conftest.py`` forces; the port under ``SCHEDULER_TORCH_MESH`` over
eight CPU devices.  On specs ``8`` and ``2x4``, with no tolerance:

* ``evict.device_pick`` (the ``EVICT_PICK`` tuple over shards) and
  ``backfill.device_fill`` (the water-fill's scan with the shards' totals
  merged a run) equal the JAX package's ``device_pick`` / ``device_fill``
  and the port's host fill on random inputs from numpy seeds, node counts
  that do not divide the mesh included;
* a preempt storm under the device eviction flavor and a backfill wave
  under the device backfill flavor, both packages on the mesh: the same
  evictions, statuses, binds and evidence.
"""

import jax
import jax.experimental
import numpy as np
import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import spec_cluster, storm_spec
from scheduler_tpu.ops import mesh as jax_mesh
from scheduler_tpu_torch.ops import mesh as M
from tests.test_torch_mesh_engine import JAX, PORT, SPECS, set_spec


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual CPU devices"
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    M.set_mesh_devices(["cpu"] * 8)
    yield
    M.set_mesh_devices(None)
    jax_mesh._cached_key = object()


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 1])
def test_pick_and_fill_match_jax_twins(monkeypatch, spec, seed):
    from scheduler_tpu.ops.backfill import device_fill as jax_fill
    from scheduler_tpu.ops.evict import device_pick as jax_pick
    from scheduler_tpu_torch.ops.backfill import _solve_runs, device_fill
    from scheduler_tpu_torch.ops.evict import device_pick

    set_spec(monkeypatch, spec)
    mesh, jmesh = M.get_mesh(), jax_mesh.get_mesh()
    rng = np.random.default_rng(seed)
    for n in (1, 100):
        pos = np.full(n, np.inf)
        hits = rng.choice(n, size=rng.integers(0, n + 1), replace=False)
        pos[hits] = hits.astype(np.float64)
        np.testing.assert_array_equal(device_pick(pos, mesh), jax_pick(pos, jmesh))
    for n, runs in ((13, 3), (100, 20)):
        rows = rng.uniform(size=(runs, n)) > 0.4
        room = rng.integers(0, 4, n)
        counts = rng.integers(0, 2 * n, runs)
        got = device_fill(rows, room, counts, mesh)
        want = jax_fill(rows, room, counts, jmesh)
        host = _solve_runs(rows, room, counts)
        for g, w, h in zip(got, want, host):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("spec", SPECS)
def test_device_flavors_on_the_mesh_match_jax(monkeypatch, spec):
    """A preempt storm under the device eviction flavor and a backfill wave
    under the device backfill flavor, both packages on the mesh: the same
    evictions, statuses and binds, each pick and fill through the mesh."""
    from tests.test_torch_backfill_engine import outcome as bf_outcome
    from tests.test_torch_backfill_engine import run as bf_run
    from tests.test_torch_backfill_engine import wave_cache
    from tests.test_torch_evict_engine import PREEMPT_CONF, outcome, run_session

    set_spec(monkeypatch, spec)
    runs = {pkg: run_session(pkg, spec_cluster(storm_spec(7, 2), pkg), PREEMPT_CONF, "device")
            for pkg in (JAX, PORT)}
    assert outcome(runs[PORT]) == outcome(runs[JAX])
    assert runs[PORT]["evictions"]
    for kind, stats in runs[PORT]["evict"].items():
        assert stats["device_picks"] == runs[JAX]["evict"][kind]["device_picks"] > 0, kind
    waves = {pkg: bf_run(pkg, wave_cache(pkg, nodes=16, wave_pods=120), "device")
             for pkg in (JAX, PORT)}
    assert bf_outcome(waves[PORT]) == bf_outcome(waves[JAX])
    assert waves[PORT]["notes"] == waves[JAX]["notes"]
    assert waves[PORT]["notes"]["backfill"]["device_binds"] > 0
