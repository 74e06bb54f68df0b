"""The mega kernel's qfair-ladder mode and full-recompute queue chain, and
the engine's ladder, against the JAX package, on the CPU.

On CPU tensors ``mega_allocate`` runs its plain version,
``mega_allocate_reference``.  Held to the JAX ``mega_allocate`` in
interpret mode on the same operands (codes and all eight stats, tolerance:
none): the ladder on staged ladder sessions (without and with static rows)
and on synthetic ladder operands (``chip_smoke.ladder_operands``), and the
full-recompute chain (``queue_delta=False``).  Held to the JAX
``FusedAllocator`` on its default device flavor: the engine's ladder
(engagement, operands, codes, ``run_stats()["qfair"]`` key for key but the
wall time), each reason it declines, and ``Scheduler.run_once``'s binds on
the ladder flagship's shape (``harness.make_mq_ladder_cluster``) at small
size.  The JAX device water-fill needs ``jax.experimental.enable_x64``,
which this jax lacks: each test here substitutes ``jax.enable_x64``.
"""

import importlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from chip_smoke import DEFAULT_TIERS_CONF, MULTIQ_CONF
from scheduler_tpu.ops.megakernel import mega_allocate as jax_mega
from scheduler_tpu_torch.interop import mega_operands_from_numpy
from scheduler_tpu_torch.ops import megakernel as mk
from tests.test_torch_megakernel import (
    JaxFused,
    TorchFused,
    jax_candidates,
    jax_conf,
    jax_open,
    kubemark_twin,
    run_both,
    torch_candidates,
    torch_conf,
    torch_open,
)
from tests.test_torch_mq_megakernel import spill_twin

MIB = 2.0**20
GIB = 2.0**30


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def ladder_twin(pkg, n_nodes, n_pods, n_queues, vocab_w):
    """``harness.make_mq_ladder_cluster`` in either package (the JAX one is
    ``bench.py``'s ``one_mq_cycle`` build)."""
    harness = importlib.import_module(f"{pkg}.harness")
    if pkg == "scheduler_tpu_torch":
        return harness.make_mq_ladder_cluster(n_nodes, n_pods, n_queues, vocab_w).cache
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    queues = tuple(f"q{i}" for i in range(n_queues))
    wide = tuple(f"bench.widevocab/r{i}" for i in range(vocab_w))

    def request(j, t):
        qi = j % n_queues
        req = {"cpu": 250.0 * (qi + 1), "memory": 256.0 * (qi + 1) * MIB}
        if wide:
            req[wide[qi % len(wide)]] = 1.0
        return req

    return harness.make_synthetic_cluster(
        n_nodes, n_pods, tasks_per_job=1, queues=queues,
        queue_weights={q: i + 1 for i, q in enumerate(queues)},
        vocab=vocab.ResourceVocabulary(wide), request_fn=request,
        node_extra={name: float(n_pods) for name in wide}).cache


def qfair_cluster(pkg):
    """``tests/test_qfair.py::_ladder_cluster`` in either package: queues
    qa, qb, qc of weights 1, 2, 3 on 4 nodes of 8 cpu, eight single-pod
    jobs a queue of 250, 500 and 750 m cpu."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache = importlib.import_module(f"{pkg}.cache.cache").SchedulerCache(
        vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    reqs = {"qa": 250.0, "qb": 500.0, "qc": 750.0}
    for i, q in enumerate(reqs):
        queue = objects.Queue(name=q, weight=i + 1)
        queue.creation_timestamp = 1_700_000_000.0 + i
        cache.add_queue(queue)
    for i in range(4):
        cache.add_node(objects.NodeSpec(name=f"n{i}", allocatable={
            "cpu": 8000.0, "memory": 32 * GIB, "pods": 110}))
    g = 0
    for q, cpu in reqs.items():
        for _ in range(8):
            pg = objects.PodGroup(name=f"g{g}", namespace="default", queue=q, min_member=1)
            pg.status.phase = "Inqueue"
            pg.creation_timestamp = 1_700_000_010.0 + g
            cache.add_pod_group(pg)
            pod = objects.PodSpec(name=f"g{g}-0", namespace="default",
                                  containers=[{"cpu": cpu, "memory": GIB}],
                                  annotations={objects.GROUP_NAME_ANNOTATION: f"g{g}"})
            pod.creation_timestamp = 1_700_000_010.0 + g
            cache.add_pod(pod)
            g += 1
    return cache


def running_twin(pkg):
    """Two queues whose pods all run already: nothing is pending."""
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache = importlib.import_module(f"{pkg}.cache.cache").SchedulerCache(
        vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    for i, q in enumerate(("qa", "qb")):
        cache.add_queue(objects.Queue(name=q, weight=i + 1))
        cache.add_node(objects.NodeSpec(name=f"n{i}", allocatable={
            "cpu": 8000.0, "memory": 32 * GIB, "pods": 110}))
        pg = objects.PodGroup(name=f"g{i}", namespace="default", queue=q, min_member=1)
        pg.status.phase = "Running"
        cache.add_pod_group(pg)
        cache.add_pod(objects.PodSpec(
            name=f"g{i}-0", namespace="default", containers=[{"cpu": 1000.0, "memory": GIB}],
            phase="Running", node_name=f"n{i}",
            annotations={objects.GROUP_NAME_ANNOTATION: f"g{i}"}))
    return cache


def engines(build, conf):
    """The JAX and the port's FusedAllocator on twins of one cluster."""
    jssn = jax_open(build("scheduler_tpu"), jax_conf(conf).tiers)
    tssn = torch_open(build("scheduler_tpu_torch"), torch_conf(conf).tiers, device="cpu")
    return (JaxFused(jssn, jax_candidates(jssn)),
            TorchFused(tssn, torch_candidates(tssn), device="cpu"))


def qfair_block(engine):
    return {k: v for k, v in engine.run_stats()["qfair"].items() if k != "solve_ms"}


# -- the kernel's modes against JAX interpret mode -------------------------------------------

# staged ladder sessions: id -> (cluster builder, conf, static rows staged)
LADDER_SESSIONS = {
    "mq-ladder-3x300": (lambda pkg: ladder_twin(pkg, 3, 300, 5, 6), MULTIQ_CONF, False),
    "mq-ladder-default-tiers": (lambda pkg: ladder_twin(pkg, 6, 300, 3, 2),
                                DEFAULT_TIERS_CONF, True),
}


@pytest.mark.parametrize("session", sorted(LADDER_SESSIONS))
def test_reference_matches_jax_in_ladder_mode(session):
    build, conf, static = LADDER_SESSIONS[session]
    jax_engine, port = engines(build, conf)
    kw = jax_engine._mega_kw
    assert jax_engine.qfair_ladder and kw["qfair_ladder"] and kw["multi_queue"]
    assert kw["use_static"] == static and not kw["batch_runs"]
    (codes_j, stats_j), (codes_t, stats_t) = run_both(jax_engine)
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(stats_t, stats_j)
    placed = int((codes_t >= 0).sum())
    assert placed > 0 and stats_t[mk.STATS.QFAIR_LOOKUPS] == placed
    assert stats_t[mk.STATS.QDELTA_UPDATES] == 0 == stats_t[mk.STATS.QFULL_RECOMPUTES]
    # The same session on the delta chain places the same.
    args = [torch.from_numpy(np.array(a)) for a in jax_engine._mega_args]
    codes_d, stats_d = mk.mega_allocate(*args, n_queues=len(port.queue_uids),
                                        **dict(port._mega_kw, qfair_ladder=False))
    np.testing.assert_array_equal(codes_d.numpy(), codes_t)
    assert stats_d[mk.STATS.QDELTA_UPDATES] == placed
    # The port's engine stages the same operands.
    for name, mine, theirs in zip(mk.OPERAND_NAMES, port._mega_args, jax_engine._mega_args):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=name)
    for key, value in port._mega_kw.items():
        assert jax_engine._mega_kw[key] == value, key


LADDER_SYNTHETIC_CPU = {
    "q3-starved": dict(seed=31, nb=128, r_dim=3, n_jobs=48, queues=3, starved=True),
    "q8-tied-static-pods": dict(seed=32, nb=128, r_dim=2, n_jobs=48, queues=8, tied=True,
                                weights=(0.0, 1.0, 1.0), use_static=True,
                                enforce_pod_count=True),
    "q4": dict(seed=33, nb=128, r_dim=2, n_jobs=48, queues=4),
}


@pytest.mark.parametrize("case", sorted(LADDER_SYNTHETIC_CPU))
def test_reference_matches_jax_on_ladder_operands(case):
    """``chip_smoke.ladder_operands`` (the card's synthetic ladder cases at
    CPU size, exact score terms) through both kernels; then the port's on
    the same operands with the full-recompute chain, which places the
    same."""
    spec = LADDER_SYNTHETIC_CPU[case]
    ops, kw = smoke.ladder_operands(exact=True, **spec)
    codes_j, stats_j = jax_mega(*(ops[name] for name in mk.OPERAND_NAMES), interpret=True,
                                **kw)
    args, torch_kw = mega_operands_from_numpy(ops, kw, "cpu")
    codes, stats = (x.numpy() for x in mk.mega_allocate(*args, n_queues=spec["queues"],
                                                        **torch_kw))
    np.testing.assert_array_equal(codes, np.asarray(codes_j))
    np.testing.assert_array_equal(stats, np.asarray(stats_j))
    codes_full, stats_full = (x.numpy() for x in mk.mega_allocate(
        *args, n_queues=spec["queues"], **dict(torch_kw, qfair_ladder=False, queue_delta=False)))
    np.testing.assert_array_equal(codes_full, codes)
    placed = int((codes >= 0).sum())
    assert placed > 0 and stats[mk.STATS.QFAIR_LOOKUPS] == placed
    assert stats_full[mk.STATS.QFULL_RECOMPUTES] == stats_full[mk.STATS.STEPS] > 0
    assert stats_full[mk.STATS.QDELTA_UPDATES] == 0 == stats_full[mk.STATS.QFAIR_LOOKUPS]
    if case == "q3-starved":
        assert placed < spec["n_jobs"], "the overused gate leaves queue 0's jobs"


@pytest.mark.parametrize("fixture", ["spill-3q", "config2-default-tiers"])
def test_full_recompute_chain_matches_jax(monkeypatch, fixture):
    """The full-recompute chain (``SCHEDULER_TORCH_QUEUE_DELTA=0``, JAX's
    ``SCHEDULER_TPU_QUEUE_DELTA=0``): the engines stage it alike, and the
    kernel matches JAX interpret mode, recomputing at every step."""
    monkeypatch.setenv("SCHEDULER_TPU_QUEUE_DELTA", "0")
    monkeypatch.setenv("SCHEDULER_TORCH_QUEUE_DELTA", "0")
    build, conf = {"spill-3q": (spill_twin, MULTIQ_CONF),
                   "config2-default-tiers": (lambda pkg: kubemark_twin(pkg, 16, 120),
                                             DEFAULT_TIERS_CONF)}[fixture]
    jax_engine, port = engines(build, conf)
    assert not jax_engine._mega_kw["queue_delta"] and not port._mega_kw["queue_delta"]
    (codes_j, stats_j), (codes_t, stats_t) = run_both(jax_engine)
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(stats_t, stats_j)
    assert stats_t[mk.STATS.QFULL_RECOMPUTES] == stats_t[mk.STATS.STEPS] > 0
    port.readback()
    np.testing.assert_array_equal(port._encoded, codes_t)
    chain = port.run_stats()["queue_chain"]
    assert chain["mode"] == "full" and chain["delta_updates"] == 0
    assert chain["full_recomputes"] == int(stats_t[mk.STATS.STEPS])
    assert qfair_block(port) == qfair_block(jax_engine)
    assert qfair_block(port)["reason"] == "queue delta chain disabled"


# -- the engine against the JAX engine's default flavor ---------------------------------------

def test_engine_ladder_matches_jax_default_flavor(monkeypatch):
    """``tests/test_qfair.py::test_ladder_engaged_codes_match_host_flavor``'s
    shape: the port's engine builds the ladder as JAX's does, launches the
    kernel in ladder mode, and its codes and evidence equal JAX's device
    flavor's and its own host flavor's codes."""
    jax_engine, port = engines(qfair_cluster, MULTIQ_CONF)
    assert jax_engine.qfair_ladder and port.qfair_ladder and port.use_mega
    assert port._mega_kw["qfair_ladder"]
    codes_j = jax_engine._execute().copy()
    port.readback()
    np.testing.assert_array_equal(port._encoded, codes_j)
    block = qfair_block(port)
    assert block == qfair_block(jax_engine)
    assert block["engaged"] and block["flavor"] == "device" and block["classes"] == 3
    assert block["rungs"] == 9 and block["ladder_lookups"] == int((codes_j >= 0).sum()) > 0
    monkeypatch.setenv("SCHEDULER_TORCH_QFAIR", "host")
    ssn = torch_open(qfair_cluster("scheduler_tpu_torch"), torch_conf(MULTIQ_CONF).tiers,
                     device="cpu")
    host = TorchFused(ssn, torch_candidates(ssn), device="cpu")
    assert not host.qfair_ladder and not host._mega_kw["qfair_ladder"]
    np.testing.assert_array_equal(host.readback(), codes_j)


# reason id -> (cluster builder, conf, environment), the JAX reason
DECLINES = {
    "kill-switch": ((lambda pkg: ladder_twin(pkg, 4, 200, 3, 2), MULTIQ_CONF,
                     {"SCHEDULER_TPU_QFAIR": "host", "SCHEDULER_TORCH_QFAIR": "host"}),
                    "SCHEDULER_TPU_QFAIR=host (kill-switch)"),
    "queue-delta": ((lambda pkg: ladder_twin(pkg, 4, 200, 3, 2), MULTIQ_CONF,
                     {"SCHEDULER_TPU_QUEUE_DELTA": "0", "SCHEDULER_TORCH_QUEUE_DELTA": "0"}),
                    "queue delta chain disabled"),
    "no-pending": ((running_twin, MULTIQ_CONF, {}), "no pending tasks"),
    "run-batching": ((spill_twin, MULTIQ_CONF, {}), "run batching (multi-copy placements)"),
    "mixed-classes": ((lambda pkg: kubemark_twin(pkg, 16, 200), DEFAULT_TIERS_CONF, {}),
                      "mixed request classes within a queue"),
    "depth-past-cap": ((lambda pkg: ladder_twin(pkg, 4, 2100, 2, 1), MULTIQ_CONF, {}),
                       "ladder depth 1051 past cap 1024"),
}


@pytest.mark.parametrize("reason", sorted(DECLINES))
def test_ladder_declines_as_jax(monkeypatch, reason):
    (build, conf, env), text = DECLINES[reason]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jax_engine, port = engines(build, conf)
    assert not jax_engine.qfair_ladder and not port.qfair_ladder
    assert port.qfair_reason == jax_engine.qfair_reason == text
    assert qfair_block(port) == qfair_block(jax_engine)
    if port.flat_count:
        assert port.use_mega and not port._mega_kw["qfair_ladder"]


@pytest.mark.parametrize("shape", [(40, 600, 5, 6), (3, 400, 5, 6)], ids=["40x600", "3x400"])
def test_scheduler_binds_as_jax_on_the_ladder_shape(tmp_path, shape):
    """``Scheduler.run_once`` on twins of the ladder flagship at small size
    (the JAX package on its default flavor, the port on its own): equal
    binds; on 3 nodes the cluster holds about half the pods, so
    proportion's share order decides who gets the rest."""
    from scheduler_tpu.scheduler import Scheduler as JaxScheduler
    from scheduler_tpu_torch.actions import allocate as torch_allocate
    from scheduler_tpu_torch.scheduler import Scheduler

    conf = tmp_path / "conf.yaml"
    conf.write_text(MULTIQ_CONF)
    jax_cache = ladder_twin("scheduler_tpu", *shape)
    JaxScheduler(jax_cache, scheduler_conf=str(conf)).run_once()
    cache = ladder_twin("scheduler_tpu_torch", *shape)
    fused = torch_allocate.routes["fused"]
    Scheduler(cache, scheduler_conf=str(conf), device="cpu").run_once()
    assert torch_allocate.routes["fused"] == fused + 1
    binds = dict(cache.binder.binds)
    assert binds == dict(jax_cache.binder.binds)
    assert (len(binds) == shape[1]) == (shape[0] == 40) and binds
