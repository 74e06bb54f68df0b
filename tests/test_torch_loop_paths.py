"""Sessions where both packages' gates pick the ``fused_allocate`` loop by
themselves, end to end against the JAX package, on the CPU.

Twins of ``chip_smoke.py``'s paths i, j and k at small scale, each more
than 4,096 request signatures (one request template a gang, or a distinct
request a pod), which close the mega kernel's gate:

* i: templates under the JAX default conf's plugin tiers (proportion makes
  the one queue multi-queue; nodeorder's weights with runs turn the top-2
  score bound on): the loop's XLA step arm;
* j: templates dealt to queues q0..q2 of weights 1:2:3 under the
  multi-queue conf (binpack alone): K1 with the loop's multi-queue pop;
* k: a releasing session (an evicted pod's node still releasing): the
  loop's releasing arm on the XLA step arm.

Each runs one ``Scheduler.run_once`` in each package.  Held equal, with no
tolerance: the session after its allocate action (every task's status and
node, FitErrors, node idle / releasing / used, proportion's queue
attributes), the engine's evidence that both packages report (the port's
own loop counters checked against its arm), and after the cycle the binds,
the cache's task statuses and node ledgers.

The JAX side runs proportion's default device water-fill, which needs
``jax.experimental.enable_x64``: this jax lacks it, and each test here
substitutes ``jax.enable_x64`` (an autouse fixture of this module only).
"""

import copy
import importlib

import jax
import jax.experimental
import pytest

import chip_smoke as smoke
from tests.test_torch_loop_arms import releasing_templates, templates
from tests.test_torch_proportion import queue_state
from tests.test_torch_releasing import PKGS, PROPORTION_CONF


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


# path -> (builder(pkg), conf, the port's engine)
PATHS = {
    "i-templates-default-tiers": (lambda pkg: templates(pkg, 64, 4200, 2),
                                  smoke.DEFAULT_TIERS_CONF, "xla"),
    "j-templates-multi-queue": (lambda pkg: templates(pkg, 64, 4200, 2, queues=True),
                                smoke.MULTIQ_CONF, "step"),
    "k-releasing-templates": (releasing_templates, PROPORTION_CONF, "xla"),
}

# The JAX engine's names of the loop's arms.
JAX_ENGINE_NAMES = {"step": "step_kernel", "xla": "xla"}


def session_state(ssn):
    """Name-keyed statuses and nodes, FitErrors, node ledgers and
    proportion's queue attributes of the open session."""
    statuses = {t.name: (t.status.name, t.node_name)
                for job in ssn.jobs.values() for t in job.tasks.values()}
    fit_errors = {t.name: job.nodes_fit_errors[t.uid].error()
                  for job in ssn.jobs.values() for t in job.tasks.values()
                  if t.uid in job.nodes_fit_errors}
    ledgers = {name: tuple(tuple(getattr(n, v).array.tolist())
                           for v in ("idle", "releasing", "used"))
               for name, n in ssn.nodes.items()}
    return statuses, fit_errors, ledgers, queue_state(ssn)


def run_once(pkg, build, conf_path, monkeypatch):
    """One ``Scheduler.run_once`` of package ``pkg``: the session after its
    allocate action, the engine's ``run_stats()``, and the cache after the
    cycle."""
    seen = {}
    fused = importlib.import_module(f"{pkg}.ops.fused").FusedAllocator
    run_stats = fused.run_stats

    def spy(self):
        out = run_stats(self)
        seen["stats"] = copy.deepcopy(out)
        return out

    monkeypatch.setattr(fused, "run_stats", spy)
    action = importlib.import_module(f"{pkg}.actions.allocate").AllocateAction
    execute = action.execute

    def execute_and_read(self, ssn):
        execute(self, ssn)
        seen["session"] = session_state(ssn)

    monkeypatch.setattr(action, "execute", execute_and_read)
    scheduler = importlib.import_module(f"{pkg}.scheduler").Scheduler
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    cache = build(pkg)
    scheduler(cache, scheduler_conf=conf_path, **kw).run_once()
    after = (dict(cache.binder.binds),
             {t.name: t.status.name for job in cache.jobs.values() for t in job.tasks.values()},
             {name: tuple(tuple(getattr(n, v).array.tolist())
                          for v in ("idle", "releasing", "used"))
              for name, n in cache.nodes.items()})
    return seen["session"], seen["stats"], after


def common_stats(stats):
    """The evidence both packages report for a loop run: the engine (in the
    JAX engine's words), cohorts, chunks, the queue chain's mode, the qfair
    block but the wall time, the placements, the signature classes."""
    out = copy.deepcopy(stats)
    out["qfair"].pop("solve_ms")
    for key in ("steps", "chain_selects", "tasks_per_step", "k1_ms", "xla_ms", "kernel_ms",
                "loop_ms"):
        out.pop(key, None)
    for key in ("delta_updates", "full_recomputes"):
        out["queue_chain"].pop(key, None)
    out["engine"] = JAX_ENGINE_NAMES.get(out["engine"], out["engine"])
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_once_on_each_loop_arm_matches_jax(path, tmp_path, monkeypatch):
    build, conf_text, engine = PATHS[path]
    conf = tmp_path / "conf.yaml"
    conf.write_text(conf_text)
    (jax_session, jax_stats, jax_after), (session, stats, after) = (
        run_once(pkg, build, str(conf), monkeypatch) for pkg in PKGS)
    assert session == jax_session
    assert after == jax_after
    assert stats["engine"] == engine
    assert common_stats(stats) == common_stats(jax_stats)
    # The port's loop counters: one delta refresh and one chain selection
    # a pop, the ladder declined.
    assert stats["queue_chain"]["delta_updates"] == stats["chain_selects"] > 0
    assert stats["qfair"]["engaged"] is False
    assert stats["steps"] >= stats["chain_selects"]
    statuses = [status for status, _ in session[0].values()]
    assert after[0] and session[1], "binds and FitErrors both"
    if path.startswith("k"):
        assert "PIPELINED" in statuses
