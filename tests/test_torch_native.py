"""The port's C++ commit ledgers (``scheduler_tpu_torch/native``) on the CPU.

Each of the six entry points of ``native/src/schedtpu.cpp`` is held bit for
bit to its numpy half (``SCHEDULER_TORCH_NATIVE=0``) and to the JAX
package's library on the same inputs; a whole cycle's commit gives the same
session state with the flag on and off; and with the flag on, a library
that does not build raises instead of dropping to numpy.
"""

import numpy as np
import pytest

import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import CONFIG2_CONF
from scheduler_tpu import native as jax_native
from scheduler_tpu_torch import native


@pytest.fixture
def numpy_half(monkeypatch):
    """Run a callable with ``SCHEDULER_TORCH_NATIVE=0`` (the numpy halves)."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setenv("SCHEDULER_TORCH_NATIVE", "0")
            assert not native.available()
            return fn(*args)
    return run


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "rows": rng.uniform(0, 10, (3000, 4)),
        "seg": rng.integers(-2, 50, 3000).astype(np.int32),
        "matrix": rng.uniform(0, 10, (800, 3)),
        "idx": rng.integers(-1, 820, 1200).astype(np.int32),
        "seg2": rng.integers(-1, 12, 1200).astype(np.int32),
        "codes": rng.choice(np.array([0, 5, 9, -1, -2, -3, -4, -12], np.int32), 2000),
    }


def _run_lengths_inputs(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (400, 2)).astype(np.float64)
    init = base.copy()
    init[rng.random(400) < 0.05, 0] += 1.0
    job = np.sort(rng.integers(0, 40, 400)).astype(np.int32)
    return base, init, job


def _calls(seed):
    """Every entry point on seeded inputs: name -> tuple of numpy results."""
    d = _inputs(seed)
    return {
        "segment_sum": lambda mod: (mod.segment_sum(d["rows"], d["seg"], 50),),
        "segment_sum_indexed": lambda mod: (
            mod.segment_sum_indexed(d["matrix"], d["idx"], d["seg2"], 12),),
        "segment_count": lambda mod: (mod.segment_count(d["seg"], 50),),
        "decode_placement_codes": lambda mod: mod.decode_placement_codes(d["codes"]),
        "run_lengths": lambda mod: (mod.run_lengths(*_run_lengths_inputs(seed)),),
        "batch_status_scatter": lambda mod: _scatter(mod, seed),
    }


def _scatter(mod, seed):
    rng = np.random.default_rng(seed)
    arrays = [np.full(n, 1, dtype=np.int16) for n in (32, 8, 64)]
    rows = [rng.choice(32, 10, replace=False), np.asarray([2]), rng.choice(64, 20, replace=False)]
    arrays[2][rows[2][3]] = 7  # a prior value that violates from_vals
    offsets = np.asarray([0, 10, 11, 31], dtype=np.int64)
    bad = mod.batch_status_scatter(arrays, np.concatenate(rows).astype(np.int64), offsets,
                                   np.asarray([1, 1, 1], np.int16),
                                   np.asarray([8, 4, 16], np.int16), True)
    return (np.asarray(bad),) + tuple(arrays)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y), (x, y)


def test_library_builds_and_loads():
    assert native.enabled()
    path = native.build()
    assert path.endswith(".so") and "build" in path
    assert native.available()


@pytest.mark.parametrize("entry", ["segment_sum", "segment_sum_indexed", "segment_count",
                                   "decode_placement_codes", "run_lengths",
                                   "batch_status_scatter"])
@pytest.mark.parametrize("seed", [0, 1])
def test_entry_point_matches_numpy_half_and_jax(entry, seed, numpy_half):
    """The C entry point bit for bit its numpy half and the JAX package's
    library (or its numpy half where the JAX library is not built)."""
    call = _calls(seed)[entry]
    got = call(native)
    _assert_same(got, numpy_half(call, native))
    _assert_same(got, call(jax_native))


def test_run_lengths_job_boundaries():
    resreq = np.array([[1.0, 2.0]] * 5 + [[3.0, 4.0]])
    job = np.array([0, 0, 0, 1, 1, 1], dtype=np.int32)
    assert native.run_lengths(resreq, resreq.copy(), job).tolist() == [3, 2, 1, 2, 1, 1]
    assert native.run_lengths(np.zeros((0, 2)), np.zeros((0, 2)),
                              np.zeros(0, np.int32)).tolist() == []


def test_decode_placement_codes_layout():
    codes = np.array([0, 7, -1, -2, -3, -5], dtype=np.int32)
    node_id, pipelined, failed, placed = native.decode_placement_codes(codes)
    assert node_id.tolist() == [0, 7, -1, -1, 0, 2]
    assert pipelined.tolist() == [False, False, False, False, True, True]
    assert failed.tolist() == [False, False, False, True, False, False]
    assert placed == 4


def test_scatter_refuses_a_column_that_is_not_int16():
    with pytest.raises(ValueError):
        native.batch_status_scatter([np.zeros(4, np.int32)], np.asarray([0], np.int64),
                                    np.asarray([0, 1], np.int64), np.asarray([0], np.int16),
                                    np.asarray([1], np.int16), False)


def _commit_state(flag, monkeypatch, tmp_path):
    """One cycle of config 2 (40 nodes x 300 pods) through
    ``Scheduler.run_once`` on the CPU with ``SCHEDULER_TORCH_NATIVE`` at
    ``flag``: binds, task statuses and each node's idle and used rows."""
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster
    from scheduler_tpu_torch.scheduler import Scheduler

    monkeypatch.setenv("SCHEDULER_TORCH_NATIVE", flag)
    cache = make_kubemark_density_cluster(40, 300).cache
    conf = tmp_path / f"conf-{flag}.yaml"
    conf.write_text(CONFIG2_CONF)
    Scheduler(cache, scheduler_conf=str(conf), device="cpu").run_once()
    statuses = {t.name: (t.status.name, t.node_name)
                for job in cache.jobs.values() for t in job.tasks.values()}
    nodes = {name: (node.idle.array.tolist(), node.used.array.tolist())
             for name, node in cache.nodes.items()}
    return dict(cache.binder.binds), statuses, nodes


def test_commit_on_and_off_gives_the_same_session_state(monkeypatch, tmp_path):
    on = _commit_state("1", monkeypatch, tmp_path)
    off = _commit_state("0", monkeypatch, tmp_path)
    assert len(on[0]) > 0
    assert on == off


def test_build_failure_raises(monkeypatch, tmp_path):
    """With the flag on, a compiler that fails makes the first call raise;
    nothing falls back to numpy.  ``=0`` is the explicit numpy path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_dir", lambda: str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    seg = np.zeros(3, np.int32)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.segment_count(seg, 2)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(force=True)
    monkeypatch.setenv("SCHEDULER_TORCH_NATIVE", "0")
    assert native.segment_count(seg, 2).tolist() == [3, 0]


def test_main_builds(capsys, monkeypatch):
    from scheduler_tpu_torch.native.__main__ import main

    monkeypatch.setattr("sys.argv", ["scheduler_tpu_torch.native", "--build"])
    assert main() == 0
    assert capsys.readouterr().out.startswith("built ")
