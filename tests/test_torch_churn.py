"""The port's churn harness (``scheduler_tpu_torch/harness/churn.py``)
against the JAX package's: the seeded histories are equal, the same history
applied straight to each package's cache binds alike under
``CHURN_CONF``, and the JAX bench's smoke shape replays over the wire
through the port's daemon loop (event trigger, k8s LIST+WATCH in) and
drains with no node overcommitted and no arrival that fits left pending."""

from __future__ import annotations

import dataclasses

import pytest

import chip_smoke as smoke
import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.apis.objects as jax_objects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.apis.objects as torch_objects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu.harness import churn as jax_churn
from scheduler_tpu.scheduler import Scheduler as JaxScheduler
from scheduler_tpu_torch.harness import churn, wire_rig
from scheduler_tpu_torch.scheduler import Scheduler

# The JAX churn bench's smoke shape.
SMOKE = dict(seed=0, nodes=32, placed_pods=200, tasks_per_job=50, pending_pods=8, lanes=4,
             rate=150.0, duration_s=1.5, warm_s=0.5)


def _events(history):
    return [(e.t, e.kind, e.op, e.obj) for e in history]


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_history_matches_jax(seed):
    kw = dict(seed=seed, rate=500.0, duration_s=2.0, lifetime_s=1.0, placed_pods=300,
              placed_lifetime_s=5.0, lanes=6)
    ours = churn.make_history(churn.ChurnConfig(**kw))
    theirs = jax_churn.make_history(jax_churn.ChurnConfig(**kw))
    assert len(ours) > 500
    assert _events(ours) == _events(theirs)
    warm = dict(kw, duration_s=0.5)
    assert _events(churn.make_history(churn.ChurnConfig(**warm), tag="warma")) == \
        _events(jax_churn.make_history(jax_churn.ChurnConfig(**warm), tag="warma"))
    assert dataclasses.asdict(churn.ChurnConfig()) == dataclasses.asdict(jax_churn.ChurnConfig())
    assert churn.CHURN_CONF == jax_churn.CHURN_CONF


def test_seed_cluster_matches_jax():
    from scheduler_tpu.connector.mock_server import MockState as JaxState
    from scheduler_tpu_torch.connector.mock_server import MockState

    kw = dict(nodes=10, placed_pods=55, pending_pods=7, tasks_per_job=20, lanes=3)
    ours, theirs = MockState(), JaxState()
    churn.seed_cluster(ours, churn.ChurnConfig(**kw))
    jax_churn.seed_cluster(theirs, jax_churn.ChurnConfig(**kw))
    assert ours.objects == theirs.objects


@pytest.mark.parametrize("seed", [1, 3])
def test_history_applied_to_the_cache_binds_as_jax(tmp_path, seed):
    kw = dict(seed=seed, nodes=12, placed_pods=90, pending_pods=6, tasks_per_job=15, lanes=3,
              rate=120.0, duration_s=1.0, lifetime_s=2.0, placed_lifetime_s=4.0)
    conf = tmp_path / "churn.yaml"
    conf.write_text(churn.CHURN_CONF)
    binds = []
    for pkg, objects in ((jax_churn, jax_objects), (churn, torch_objects)):
        cfg = pkg.ChurnConfig(**kw)
        with wire_rig.ObjectClock(objects):
            cache = pkg.seed_cache(cfg)
            applied = pkg.apply_history_to_cache(cache, pkg.make_history(cfg))
            sched = JaxScheduler(cache, str(conf)) if pkg is jax_churn else \
                Scheduler(cache, str(conf), device="cpu")
            sched.run_once()
        binds.append((applied, dict(cache.binder.binds)))
    assert binds[0][0] > 50 and len(binds[0][1]) > 10
    assert binds[1] == binds[0]


def test_smoke_shape_replays_through_the_daemon(monkeypatch):
    for flag in ("TRIGGER", "DEBOUNCE_MS", "TRIGGER_MIN_MS", "TRIGGER_MAX_MS"):
        monkeypatch.delenv(f"SCHEDULER_TORCH_{flag}", raising=False)
    rec = smoke.phase_churn(SMOKE, device="cpu")
    assert rec["cycles_measured"] > 0 and rec["p99_ms"] >= rec["p50_ms"] > 0
    assert rec["replay"]["events"] > 100 and rec["rate_sustained"] > 0
    assert rec["trigger"]["events"] > 0 and rec["trigger"]["cycles"] > 0
    assert rec["ingest"]["wire"] == "K8sApiConnector"
    assert rec["ingest"]["events_applied"] > rec["replay"]["events"]
    assert sum(rec["engine_cache"].values()) == rec["cycles_measured"]
    assert rec["server_bound"] > 200 and rec["server_pending"] == 0
