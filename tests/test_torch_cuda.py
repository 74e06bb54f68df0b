"""The port's CUDA kernel on the card (marked ``cuda``: skips without a GPU).

A CUDA kernel has no CPU mode, so these tests run only where
``torch.cuda.is_available()``; the CPU suite reaches the same arithmetic
through the plain version (``test_torch_megakernel.py``).  This file imports
nothing of JAX, so it runs on a GPU machine without it, from the root of a
checkout (``--noconftest``: the suite's conftest imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each case builds a session with the port's harness on the card, launches
``mega_allocate`` and holds it against ``mega_allocate_reference`` on the
same CUDA operands: codes and stats bitwise equal (tolerance: none).
"""

import pytest
import torch

import chip_smoke as smoke
import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu_torch.harness import make_synthetic_cluster
from scheduler_tpu_torch.ops import megakernel as mk


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spill_cluster():
    """Identical-request gangs larger than one node's room on a cluster too
    small for them all: runs batch, cohorts spill across nodes, and some
    gangs fail."""
    return make_synthetic_cluster(
        8, 1600, tasks_per_job=100, request_fn=smoke.uniform_gang_request
    ).cache


# case id -> (cluster builder, conf, kernel-argument overrides)
CASES = {
    "config1": (smoke.config1_cluster, smoke.CONFIG1_CONF, {}),
    "spill-cohort-1": (_spill_cluster, smoke.FLAGSHIP_CONF, {"cohort": 1}),
    "spill-cohort-4": (_spill_cluster, smoke.FLAGSHIP_CONF, {"cohort": 4}),
    "score-bound-pod-count": (
        _spill_cluster, smoke.FLAGSHIP_CONF,
        {"weights": (1.0, 1.0, 1.0), "score_bound": True, "enforce_pod_count": True,
         "cohort": 4},
    ),
    # More than 5,000 jobs: the kernel keeps its job ledger in global scratch.
    "global-job-ledger": (smoke.many_jobs_cluster, smoke.FLAGSHIP_CONF, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version(case):
    device = _card()
    build, conf, overrides = CASES[case]
    _, engine = smoke.engine_for(build(), conf, device)
    kw = dict(engine._mega_kw, **overrides)
    j_pad = dict(zip(mk.OPERAND_NAMES, engine._mega_args))["job_off"].shape[1]
    assert mk.job_ledger_in_global(j_pad, kw["r_dim"]) == (case == "global-job-ledger")
    before = mk.launches
    codes, stats = mk.mega_allocate(*engine._mega_args, **kw)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ref_codes, ref_stats = mk.mega_allocate_reference(*engine._mega_args, **kw)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(stats, ref_stats)
    assert int((codes >= 0).sum()) > 0


@pytest.mark.cuda
def test_scheduler_on_cuda_binds_as_the_host_loop(tmp_path):
    """``Scheduler.run_once`` on the card (fused route, one kernel launch)
    binds exactly what the port's host loop binds on the same cluster."""
    _card()
    from scheduler_tpu_torch.actions import allocate
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.scheduler import Scheduler

    conf = tmp_path / "conf.yaml"
    conf.write_text(smoke.FLAGSHIP_CONF)
    gpu = make_synthetic_cluster(64, 600, tasks_per_job=10).cache
    launches, fused = mk.launches, allocate.routes["fused"]
    Scheduler(gpu, scheduler_conf=str(conf)).run_once()
    assert mk.launches == launches + 1 and allocate.routes["fused"] == fused + 1
    host = make_synthetic_cluster(64, 600, tasks_per_job=10).cache
    ssn = open_session(host, parse_scheduler_conf(smoke.FLAGSHIP_CONF).tiers, device="cpu")
    AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
    close_session(ssn)
    assert dict(gpu.binder.binds) == dict(host.binder.binds)
    assert len(gpu.binder.binds) == 600
