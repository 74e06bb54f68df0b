"""The mega kernel's multi-queue mode on synthetic operands, and its launch
plan, on the CPU.

``chip_smoke.mega_operands(queues=...)`` (the operands of the card's
synthetic multi-queue K2 cases, at CPU size and with exact score terms) go
through the JAX kernel in interpret mode and the port's plain version:
codes and stats bitwise equal (tolerance: none).  The cases cover 2 to 8
queues with one queue empty, a queue starved by its overused gate, equal
shares across queues, both instantiations and one and four cohort chunks.
``mega_plan`` must place the queue ledger on chip for every shape the mega
gate admits.
"""

import numpy as np
import pytest

import chip_smoke as smoke
from scheduler_tpu.ops.megakernel import mega_allocate as jax_mega
from scheduler_tpu_torch.interop import mega_operands_from_numpy
from scheduler_tpu_torch.ops import megakernel as mk

# chip_smoke.MEGA_SYNTHETIC_MQ's cases at CPU size.
SYNTHETIC_MQ_CPU = {
    "q3-starved": dict(seed=11, nb=256, r_dim=2, n_jobs=40, queues=3, starved=True),
    "q8-tied-all-terms-pods": dict(seed=12, nb=256, r_dim=3, n_jobs=40, queues=8, tied=True,
                                   weights=(1.0, 0.0, 1.0), score_bound=True,
                                   enforce_pod_count=True),
    "q2-static": dict(seed=13, nb=256, r_dim=2, n_jobs=40, queues=2, use_static=True,
                      weights=(0.0, 1.0, 1.0), score_bound=True),
}


def queue_placements(ops, codes, n_jobs):
    """Placements per queue index."""
    jq, off, num = ops["jqueue"][0], ops["job_off"][0], ops["job_num"][0]
    out = {}
    for j in range(n_jobs):
        got = codes[off[j] : off[j] + num[j]]
        out[int(jq[j])] = out.get(int(jq[j]), 0) + int((got >= 0).sum())
    return out


@pytest.mark.parametrize("cohort", [1, 4])
@pytest.mark.parametrize("case", sorted(SYNTHETIC_MQ_CPU))
def test_reference_matches_jax_on_multi_queue_operands(case, cohort):
    spec = dict(SYNTHETIC_MQ_CPU[case], cohort=cohort)
    ops, kw = smoke.mega_operands(exact=True, **spec)
    codes_j, stats_j = jax_mega(*(ops[name] for name in mk.OPERAND_NAMES), interpret=True, **kw)
    args, torch_kw = mega_operands_from_numpy(ops, kw, "cpu")
    codes_t, stats_t = mk.mega_allocate(*args, n_queues=spec["queues"], **torch_kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(stats_t.numpy(), np.asarray(stats_j))
    codes = codes_t.numpy()
    placed = queue_placements(ops, codes, spec["n_jobs"])
    assert stats_t[mk.STATS.QDELTA_UPDATES] > 0 and sum(placed.values()) > 0
    if spec["queues"] > 2:
        assert 1 not in placed, "queue 1 holds no job"
    if case == "q3-starved":
        # Queue 0 deserves almost nothing: its first placements overuse it,
        # and its jobs are left pending.
        assert 0 < placed[0] < 8 and int((codes == mk.UNPLACED).sum()) > 0


def test_multi_queue_wrapper_checks_the_queue_operands():
    """In multi-queue mode the wrapper's checks cover the queue operands:
    the queue count is required and must cover every queue a job names;
    the qfair ladder needs the delta chain."""
    ops, kw = smoke.mega_operands(**SYNTHETIC_MQ_CPU["q3-starved"])
    args, kw = mega_operands_from_numpy(ops, kw, "cpu")
    assert int(args[mk.OPERAND_NAMES.index("jqueue")].max()) == 2
    plan = mk.plan_for(args, kw, 3)
    assert plan.off_queue is not None and "queue_ledger" in plan.summary()["on_chip"]
    for n_queues in (None, 0, 2):
        with pytest.raises(ValueError, match="queue"):
            mk.mega_allocate(*args, n_queues=n_queues, **kw)
    with pytest.raises(ValueError, match="n_queues"):
        mk.plan_for(args, kw)
    with pytest.raises(ValueError, match="qfair ladder"):
        mk.mega_allocate(*args, n_queues=3, **dict(kw, queue_delta=False, qfair_ladder=True))


PLAN_NB = (128, 1024, 10_112, 16_384, 32_768)
PLAN_J_PAD = (256, 1152, 8320, 16_384)
PLAN_QUEUES = (1, 3, 128, 1024)


@pytest.mark.parametrize("r_dim", [1, 2, 3, 8])
def test_mega_plan_places_the_queue_ledger(r_dim):
    """Every admitted shape with 1 to 1,024 queues: the queue ledger on chip
    right after the node slice, then the other regions in the plan's order
    where they still fit (the job operands one word wider a lane for the
    queue index); the job ledger may leave the chip (j_pad 8,320 and up)."""
    budget = mk.SMEM_LIMIT - mk._STATIC_SMEM
    for nb in PLAN_NB:
        max_rows = (4 * 1024 * 1024) // (nb * 8)
        for j_pad in PLAN_J_PAD:
            for n_queues in PLAN_QUEUES:
                for use_static, rows in ((False, 8), (True, min(64, max_rows))):
                    plan = mk.mega_plan(nb, r_dim, j_pad, 128, rows, use_static, n_queues)
                    shape = (nb, r_dim, j_pad, n_queues, use_static)
                    node = mk.node_slice_bytes(plan.slice, r_dim)
                    assert plan.off_queue == node, shape
                    used = node + mk.queue_ledger_bytes(n_queues, r_dim)
                    for off, size in (
                        (plan.off_js, mk.job_ledger_bytes(j_pad, r_dim)),
                        (plan.off_sig, 2 * r_dim * 128 * 4),
                        (plan.off_job, 7 * j_pad * 4),
                        (plan.off_static, 2 * rows * plan.slice * 4 if use_static else None),
                    ):
                        fits = size is not None and used + size <= budget
                        assert (off is not None) == fits, shape
                        if fits:
                            assert off == used and off % 16 == 0
                            used = -(-(used + size) // 16) * 16
                    assert plan.smem_bytes == used <= budget


def test_mega_plan_at_the_multi_queue_main_paths():
    """The plans of the three-queue flagship (10k nodes, 1,000 gangs) and of
    config 2 under the default tiers (one queue, 5,000 jobs: j_pad 8,320,
    the job ledger still on chip, the job operands not)."""
    flagship = mk.mega_plan(16_384, 2, 1152, 128, 8, False, 3)
    assert flagship.ctas == 8 and flagship.summary()["on_chip"] == [
        "queue_ledger", "job_ledger", "sig_req", "job_operands"]
    config2 = mk.mega_plan(1024, 2, 8320, 128, 8, True, 1)
    assert config2.ctas == 8 and not config2.job_ledger_in_global
    assert config2.off_job is None and config2.off_static is not None
