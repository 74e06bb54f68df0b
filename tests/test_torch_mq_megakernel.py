"""The port's mega kernel in MULTI-QUEUE MODE against the JAX one, on the CPU.

As in ``test_torch_megakernel.py``: the JAX package's ``FusedAllocator``
stages a session (proportion on its host water-fill,
``SCHEDULER_TPU_QFAIR=host``), the JAX ``mega_allocate`` runs in interpret
mode, and the port runs ``mega_allocate`` on the same operands converted by
``interop.mega_operands_from_numpy`` (CPU tensors: the plain version,
``mega_allocate_reference``): codes and all eight stats bitwise equal
(tolerance: none), at one and four cohort chunks, in both instantiations
(cursor and static rows).  The port's own engine build must stage the same
operands.  Synthetic multi-queue operands and the launch plan are in
``test_torch_mq_synthetic.py``.
"""

import importlib

import numpy as np
import pytest

from chip_smoke import DEFAULT_TIERS_CONF, MULTIQ_CONF, multi_queue_spec, uniform_gang_request
from scheduler_tpu_torch.ops import megakernel as mk
from tests.test_torch_megakernel import (
    TorchFused,
    build_twin,
    gpu_topology_twin,
    jax_candidates,
    jax_conf,
    jax_open,
    JaxFused,
    kubemark_twin,
    run_both,
    torch_candidates,
    torch_conf,
    torch_open,
)


def spill_twin(pkg):
    """Three queues (weights 1:2:3) of identical-request gangs larger than
    a node's room on 8 nodes: runs batch, cohorts spill across nodes, and
    the queues' shares move by whole batches."""
    harness = importlib.import_module(f"{pkg}.harness")
    queues = ("q0", "q1", "q2")
    return harness.make_synthetic_cluster(
        8, 1200, tasks_per_job=100, request_fn=uniform_gang_request, queues=queues,
        queue_weights={q: i + 1 for i, q in enumerate(queues)}).cache


# fixture id -> (cluster builder(pkg), conf, static rows staged)
FIXTURES = {
    "spill-3q": (spill_twin, MULTIQ_CONF, False),
    # Weights 1:9 on 3 nodes: q0 turns overused partway and is denied.
    "starvation": (lambda pkg: build_twin(pkg, multi_queue_spec((1, 9), 3)), MULTIQ_CONF, False),
    # Config 2 under the default conf's tiers: one queue, multi-queue mode.
    "config2-default-tiers": (lambda pkg: kubemark_twin(pkg, 64, 400), DEFAULT_TIERS_CONF, True),
    # Config 5's gangs under the default tiers: runs, the score bound, static rows.
    "config5-default-tiers": (lambda pkg: gpu_topology_twin(pkg, 40, 30), DEFAULT_TIERS_CONF,
                              True),
}


@pytest.fixture(autouse=True)
def _host_water_fill(monkeypatch):
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "host")


def jax_engine(monkeypatch, fixture, cohort):
    build, conf, _ = FIXTURES[fixture]
    monkeypatch.setenv("SCHEDULER_TPU_COHORT", str(cohort))
    ssn = jax_open(build("scheduler_tpu"), jax_conf(conf).tiers)
    engine = JaxFused(ssn, jax_candidates(ssn))
    assert engine.use_mega and engine._mega_kw["multi_queue"]
    return engine


@pytest.mark.parametrize("cohort", [1, 4])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_reference_matches_jax_multi_queue(monkeypatch, fixture, cohort):
    engine = jax_engine(monkeypatch, fixture, cohort)
    kw = engine._mega_kw
    assert kw["queue_proportion"] and kw["overused_gate"] and kw["queue_delta"]
    assert not (kw["cross_batch"] or kw["qfair_ladder"] or kw["has_releasing"])
    assert kw["use_static"] == FIXTURES[fixture][2]
    if fixture == "spill-3q":
        assert engine.batch_runs and engine.cohort_effective == cohort
    if fixture == "config5-default-tiers":
        # A gang of 8 fits one 8-GPU node: runs batch but never spill.
        assert engine.batch_runs and kw["score_bound"]
    (codes_j, stats_j), (codes_t, stats_t) = run_both(engine)
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(stats_t, stats_j)
    placed = int((codes_t >= 0).sum())
    assert placed > 0
    assert stats_t[mk.STATS.QDELTA_UPDATES] > 0
    if fixture == "starvation":
        assert placed < engine.flat_count, "the overused gate denies q0 the rest"
    if cohort == 4 and fixture == "spill-3q":
        assert stats_t[mk.STATS.CHUNK_PLACED] > 0


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_port_stages_the_jax_multi_queue_operands(monkeypatch, fixture):
    """The port's FusedAllocator stages the same 26 operands, the queue
    operands among them, and the same static arguments as the JAX one."""
    build, conf, _ = FIXTURES[fixture]
    engine = jax_engine(monkeypatch, fixture, 1)
    ssn = torch_open(build("scheduler_tpu_torch"), torch_conf(conf).tiers, device="cpu")
    port = TorchFused(ssn, torch_candidates(ssn), device="cpu")
    assert port.use_mega
    for name, mine, theirs in zip(mk.OPERAND_NAMES, port._mega_args, engine._mega_args):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=name)
    for key, value in port._mega_kw.items():
        assert engine._mega_kw[key] == value, key
    port.readback()
    stats = port.run_stats()
    chain = stats["queue_chain"]
    assert chain["queues"] == len(ssn.queues) and chain["mode"] == "delta"
    assert chain["delta_updates"] > 0 and chain["full_recomputes"] == 0
    # The port on its default flavor (the JAX engine here on its host one):
    # the device water-fill, and no ladder on these shapes.
    assert stats["qfair"]["flavor"] == "device" and not stats["qfair"]["engaged"]
    assert stats["qfair"]["reason"] in ("run batching (multi-copy placements)",
                                        "mixed request classes within a queue")
