"""The port's device water-fill (``ops/qfair.py``) against the JAX package's,
on the CPU.

On CPU tensors ``qfair_solve`` runs its plain version,
``qfair_solve_reference``, the float64 twin of ``csrc/qfair_solve.cu``.
It is held, bitwise (tolerance: none, float64 compared bit for bit), to:

* the JAX device solve (``scheduler_tpu.ops.qfair.solve_deserved``), on
  random fleets of 1 to 128 queues and on proportion's sessions;
* the port's own host water-fill (the ``SCHEDULER_TORCH_QFAIR=host``
  kill-switch), through proportion's queue attributes;
* JAX's evidence when a one-round budget makes proportion fall back to
  the host loop;

and the ladder's host half (``single_class_queues``, ``build_ladder``) to
JAX's arrays.  The JAX solve needs ``jax.experimental.enable_x64``, which
this jax lacks: each test here substitutes ``jax.enable_x64`` for it.
"""

import importlib

import jax
import jax.experimental
import numpy as np
import pytest

import scheduler_tpu.plugins  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu.ops import qfair as jax_qfair
from scheduler_tpu_torch.ops import qfair

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
PROPORTION_CONF = 'actions: "allocate"\ntiers:\n- plugins:\n  - name: proportion\n'
GPU = "nvidia.com/gpu"


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


def random_fleet(rng, q_n, r_n):
    """One fleet's solve operands: integer or real weights, some queues
    asking far less than their slice (capped early), scalar requests on
    some queues only (the scalar-map branch), a pool that may run dry."""
    weights = (rng.integers(1, 10, q_n).astype(np.float64) if rng.random() < 0.5
               else rng.uniform(1.0, 5.0, q_n))
    request = rng.uniform(100.0, 4000.0, (q_n, r_n))
    request[rng.random(q_n) < 0.3] *= 0.05
    request[:, 2:][rng.random((q_n, r_n - 2)) < 0.5] = 0.0
    return {
        "weights": weights, "request": request,
        "total": rng.uniform(2000.0, 90_000.0, r_n) * max(1, q_n // 8),
        "req_has_scalars": request[:, 2:].sum(axis=1) > 0,
        "total_has_scalars": bool(rng.random() < 0.7),
        "mins": np.full(r_n, 1e-2),
    }


# The kernel's tiling (csrc/qfair_solve.cu: a warp a queue, a thread a dim
# and a fold): one queue, a warp's worth and one more, more queues than one
# CTA has warps; two, three and forty dims (past a warp's lanes).
@pytest.mark.parametrize("q_n,r_n,seed", [
    (1, 2, 0), (2, 2, 1), (3, 4, 2), (5, 3, 3), (8, 8, 4), (17, 6, 5), (40, 18, 6),
    (100, 8, 7), (128, 3, 8),
    (1, 40, 9), (33, 2, 10), (33, 3, 11), (33, 40, 12), (300, 3, 13), (300, 40, 14),
])
def test_solve_matches_jax_device_solve(q_n, r_n, seed):
    fleet = random_fleet(np.random.default_rng(seed), q_n, r_n)
    want = jax_qfair.solve_deserved(**fleet)
    got = qfair.solve_deserved(**fleet, device="cpu")
    np.testing.assert_array_equal(bits(got["deserved"]), bits(want["deserved"]))
    np.testing.assert_array_equal(got["met"], want["met"])
    for key in ("iterations", "converged_at", "converged"):
        assert got[key] == want[key], key
    assert got["iterations"] == q_n + 4 and got["converged"]


@pytest.mark.parametrize("q_n,r_n,seed,iters", [(33, 3, 15, 1), (300, 40, 16, 2)])
def test_solve_budget_cut_matches_jax_device_solve(monkeypatch, q_n, r_n, seed, iters):
    """A round budget that runs out before the fixed point (both packages'
    ``*_QFAIR_ITERS``): the partial deserved rows, met flags and evidence
    equal, ``converged_at`` -1."""
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR_ITERS", str(iters))
    monkeypatch.setenv("SCHEDULER_TORCH_QFAIR_ITERS", str(iters))
    fleet = random_fleet(np.random.default_rng(seed), q_n, r_n)
    want = jax_qfair.solve_deserved(**fleet)
    got = qfair.solve_deserved(**fleet, device="cpu")
    np.testing.assert_array_equal(bits(got["deserved"]), bits(want["deserved"]))
    np.testing.assert_array_equal(got["met"], want["met"])
    for key in ("iterations", "converged_at", "converged"):
        assert got[key] == want[key], key
    assert got["iterations"] == iters and got["converged_at"] == -1 and not got["converged"]


# -- through proportion, in both packages ----------------------------------------------

def fair_cluster(pkg, weights, capped=(), scalars=False):
    """``tests/test_qfair.py::_fair_cluster`` in either package: queues of
    the given weights, 3 nodes of 8 cpu and 32 GiB (and 8 GPUs with
    ``scalars``), six 2-cpu pods a queue (one 0.4-cpu pod for a capped
    queue), every other pod asking a GPU with ``scalars``."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache = importlib.import_module(f"{pkg}.cache.cache").SchedulerCache(
        vocab=vocab.ResourceVocabulary((GPU,) if scalars else ()), async_io=False)
    cache.run()
    for q, w in weights.items():
        cache.add_queue(objects.Queue(name=q, weight=w))
    for i in range(3):
        alloc = {"cpu": 8000.0, "memory": 32 * 2.0**30, "pods": 110}
        if scalars:
            alloc[GPU] = 8.0
        cache.add_node(objects.NodeSpec(name=f"n{i}", allocatable=alloc))
    for gi, q in enumerate(weights):
        pg = objects.PodGroup(name=f"g{gi}", namespace="default", queue=q, min_member=1)
        pg.status.phase = "Inqueue"
        cache.add_pod_group(pg)
        for i in range(1 if q in capped else 6):
            req = {"cpu": 400.0 if q in capped else 2000.0, "memory": 2.0**30}
            if scalars and i % 2:
                req[GPU] = 1.0
            cache.add_pod(objects.PodSpec(
                name=f"g{gi}-{i}", namespace="default", containers=[req],
                annotations={objects.GROUP_NAME_ANNOTATION: f"g{gi}"}))
    return cache


def solve_snapshot(pkg, cache):
    """Open a session (proportion alone) and read proportion's fixed point:
    each queue's deserved row, share and scalar-map presence, and the
    evidence block."""
    conf = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    ssn = framework.open_session(cache, conf.parse_scheduler_conf(PROPORTION_CONF).tiers, **kw)
    try:
        plugin = ssn.plugins["proportion"]
        snap = {uid: (bits(a.deserved.array).tolist(), a.share, a.deserved.has_scalars)
                for uid, a in plugin.queue_attrs.items()}
        return snap, dict(plugin._qfair_evidence)
    finally:
        framework.close_session(ssn)


FAIR_CASES = [
    ({"qa": 1}, (), False),
    ({"qa": 1, "qb": 1}, (), False),
    ({"qa": 1, "qb": 3}, (), False),
    ({"qa": 1, "qb": 9}, ("qa",), False),
    ({"qa": 2, "qb": 3, "qc": 5}, (), False),
    ({"qa": 1, "qb": 4, "qc": 2}, ("qb",), False),
    ({"qa": 1, "qb": 3, "qc": 1}, ("qa", "qc"), False),
    ({"qa": 1, "qb": 2}, (), True),
    ({"qa": 3, "qb": 1, "qc": 1}, ("qb",), True),
]
FAIR_IDS = ["1q", "2q-even", "2q-skew", "2q-capped", "3q-skew", "3q-capped",
            "3q-two-capped", "2q-scalars", "3q-scalars-capped"]


@pytest.mark.parametrize("weights,capped,scalars", FAIR_CASES, ids=FAIR_IDS)
def test_proportion_device_solve_matches_jax_and_host(monkeypatch, weights, capped, scalars):
    """Proportion's deserved rows, shares and scalar-map presence: the
    port's device flavor equals the JAX package's device flavor and the
    port's host water-fill, bit for bit; the evidence blocks agree apart
    from the wall time."""
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "device")
    jax_dev, jax_ev = solve_snapshot("scheduler_tpu", fair_cluster(
        "scheduler_tpu", weights, capped, scalars))
    port = fair_cluster("scheduler_tpu_torch", weights, capped, scalars)
    dev, ev = solve_snapshot("scheduler_tpu_torch", port)
    monkeypatch.setenv("SCHEDULER_TORCH_QFAIR", "host")
    host, ev_host = solve_snapshot("scheduler_tpu_torch", port)
    assert set(dev) == set(weights)
    assert dev == jax_dev == host
    assert ev["flavor"] == "device" and ev_host["flavor"] == "host"
    assert {k: v for k, v in ev.items() if k != "solve_ms"} == {
        k: v for k, v in jax_ev.items() if k != "solve_ms"}
    assert ev["iterations"] == len(weights) + 4 and 0 <= ev["converged_at"] <= ev["iterations"]


def test_short_budget_falls_back_to_the_host_loop(monkeypatch):
    """A one-round budget that does not reach the fixed point: proportion
    falls back to the host loop, its shares are the host loop's, and the
    evidence is JAX's (apart from the wall times)."""
    weights, capped = {"qa": 1, "qb": 3, "qc": 2}, ("qa",)
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR_ITERS", "1")
    monkeypatch.setenv("SCHEDULER_TORCH_QFAIR_ITERS", "1")
    jax_got, jax_ev = solve_snapshot("scheduler_tpu", fair_cluster(
        "scheduler_tpu", weights, capped, True))
    port = fair_cluster("scheduler_tpu_torch", weights, capped, True)
    got, ev = solve_snapshot("scheduler_tpu_torch", port)
    monkeypatch.setenv("SCHEDULER_TORCH_QFAIR", "host")
    host, _ = solve_snapshot("scheduler_tpu_torch", port)
    assert ev["flavor"] == "host" and ev["fallback"] == "not converged"
    assert ev["iterations"] == 1
    walls = ("solve_ms", "device_solve_ms")
    assert {k: v for k, v in ev.items() if k not in walls} == {
        k: v for k, v in jax_ev.items() if k not in walls}
    assert got == host == jax_got


def test_flavor_knobs_parse_as_jax():
    """The port's knobs mirror the JAX ones: a value outside the choices
    warns and keeps the default; the round budget clamps."""
    import os

    env = dict(os.environ)
    try:
        for value, flavor in (("device", "device"), ("HOST", "host"), ("gpu", "device")):
            os.environ["SCHEDULER_TORCH_QFAIR"] = value
            assert qfair.qfair_flavor() == flavor
        for value, iters in (("0", 0), ("7", 7), ("-3", 0), ("x", 0), ("99999", 10_000)):
            os.environ["SCHEDULER_TORCH_QFAIR_ITERS"] = value
            assert qfair.qfair_iters() == iters
    finally:
        os.environ.clear()
        os.environ.update(env)


def test_wrapper_runs_plain_version_on_cpu():
    import torch

    fleet = random_fleet(np.random.default_rng(3), 6, 4)
    ops = [torch.from_numpy(np.asarray(fleet[k])) for k in
           ("weights", "request", "total", "req_has_scalars")]
    before = qfair.launches
    got = qfair.qfair_solve(*ops, fleet["total_has_scalars"], torch.from_numpy(fleet["mins"]),
                            iters=10)
    ref = qfair.qfair_solve_reference(*ops, fleet["total_has_scalars"],
                                      torch.from_numpy(fleet["mins"]), iters=10)
    assert qfair.launches == before, "the CPU path launches no kernel"
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[2].tolist()[0] == 10


# -- the ladder's host half -------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_ladder_tables_match_jax(seed):
    rng = np.random.default_rng(seed)
    q_n, r_n = int(rng.integers(1, 20)), int(rng.integers(2, 9))
    t_n = int(rng.integers(0, 400))
    queue_of_task = rng.integers(0, q_n, t_n)
    class_of_queue = rng.integers(0, 50, q_n)
    sig = class_of_queue[queue_of_task]
    if seed == 3 and t_n:
        sig = sig.copy()
        sig[-1] += 1  # one queue of two classes
    for mod in (qfair, jax_qfair):
        assert mod.LADDER_CAP == 1024
    want = jax_qfair.single_class_queues(sig, queue_of_task, q_n)
    got = qfair.single_class_queues(sig, queue_of_task, q_n)
    assert got[0] == want[0] == (seed != 3 or t_n == 0)
    np.testing.assert_array_equal(got[1], want[1])
    if want[0]:
        np.testing.assert_array_equal(got[2], want[2])
    des = rng.uniform(0.0, 400.0, (q_n, r_n)).astype(np.float32)
    des[rng.random((q_n, r_n)) < 0.2] = 0.0
    held = (des * rng.choice([0.0, 0.25, 0.5], (q_n, 1))).astype(np.float32)
    req = rng.choice([0.0, 0.25, 0.7, 3.0], (q_n, r_n)).astype(np.float32)
    mins = np.full(r_n, 0.01, np.float32)
    counts = np.asarray(got[1], dtype=np.int64)
    for a, b in zip(qfair.build_ladder(des, held, req, counts, mins, r_n),
                    jax_qfair.build_ladder(des, held, req, counts, mins, r_n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
