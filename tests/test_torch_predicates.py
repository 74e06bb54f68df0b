"""The predicates and nodeorder plugins and the static-predicate kernel of
the port against the JAX package, on the CPU.

* The kernel's wrapper on CPU tensors runs its plain PyTorch version, held
  to the JAX Pallas kernel (interpret mode, as ``tests/test_pallas.py`` runs
  it) on the shapes of that file plus empty vocabularies and an empty task
  axis.  Tolerance: none (bool masks).
* The plugins' device builders, on one twin cluster built in both packages:
  the [T, N] static mask equal and the [T, N] static score bitwise equal.
* The host predicate on every (task, node) pair: the same pass or fail and
  the same FitError string.
* A conf naming a plugin of the JAX package that the port does not carry
  raises instead of running without it.
"""

import importlib

import numpy as np
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu.ops import pallas_kernels
from scheduler_tpu_torch.ops import predicate_kernel as pk
from tests.test_torch_megakernel import PRESSURE_CONF, build_twin, predicates_spec

# tests/test_pallas.py's shapes, then an empty label and an empty taint
# vocabulary (config 2 has no taint).
SHAPES = [(1, 1, 0, 0), (3, 5, 4, 2), (130, 200, 7, 3), (256, 128, 40, 17),
          (40, 70, 0, 5), (40, 70, 9, 0)]


def _operands(t, n, l, k):
    rng = np.random.default_rng(t * 1000 + n)
    return (rng.random((t, l)) < 0.2, rng.random(t) < 0.1, rng.random((n, l)) < 0.5,
            rng.random(n) < 0.15, rng.random((n, k)) < 0.3, rng.random((t, k)) < 0.5)


@pytest.mark.parametrize("t,n,l,k", SHAPES)
def test_plain_version_matches_jax_kernel(t, n, l, k):
    ops = _operands(t, n, l, k)
    expected = pallas_kernels.static_predicate_mask(*ops)
    before = pk.launches
    got = pk.static_predicate_mask(*(torch.from_numpy(a) for a in ops))
    assert pk.launches == before, "the CPU path launches no kernel"
    assert got.dtype == torch.bool and tuple(got.shape) == (t, n)
    np.testing.assert_array_equal(got.numpy(), expected)
    if l and k:
        assert 0 < int(got.sum()) < t * n, "the mask must cut some pairs and keep others"


def test_empty_task_axis_is_all_true_without_a_launch():
    ops = (np.zeros((0, 3), bool), np.zeros(0, bool), np.zeros((4, 3), bool),
           np.zeros(4, bool), np.zeros((4, 1), bool), np.zeros((0, 1), bool))
    expected = pallas_kernels.static_predicate_mask(*ops)
    got = pk.static_predicate_mask(*(torch.from_numpy(a) for a in ops))
    assert tuple(got.shape) == expected.shape == (0, 4)


def test_wrapper_checks_its_operands():
    ops = [torch.from_numpy(a) for a in _operands(3, 5, 4, 2)]
    with pytest.raises(ValueError, match="torch.bool"):
        pk.static_predicate_mask(ops[0].to(torch.uint8), *ops[1:])
    with pytest.raises(ValueError, match="shape"):
        pk.static_predicate_mask(ops[0][:, :3], *ops[1:])


# -- the plugins' device builders and host predicate, port vs JAX ----------------

def _session(pkg):
    conf = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    cache = build_twin(pkg, predicates_spec())
    return framework.open_session(cache, conf.parse_scheduler_conf(PRESSURE_CONF).tiers, **kw)


def _engine(pkg, ssn):
    candidates = importlib.import_module(f"{pkg}.actions.allocate").collect_candidates(ssn)
    fused = importlib.import_module(f"{pkg}.ops.fused")
    if pkg == "scheduler_tpu_torch":
        return fused.FusedAllocator(ssn, candidates, device="cpu")
    return fused.FusedAllocator(ssn, candidates)


def test_device_builders_match_jax():
    """The [T, N] static mask and score that the predicates and nodeorder
    builders contribute, combined and padded by
    ``build_static_tensors_device``: mask equal, score bitwise."""
    from scheduler_tpu.ops.allocator import build_static_tensors_device as jax_build
    from scheduler_tpu_torch.ops.allocator import build_static_tensors_device

    jax_ssn, ssn = _session("scheduler_tpu"), _session("scheduler_tpu_torch")
    assert set(ssn.device_predicates) == set(jax_ssn.device_predicates) == {"predicates"}
    assert set(ssn.device_scorers) == set(jax_ssn.device_scorers) == {"nodeorder"}
    assert ssn.device_score_weights == jax_ssn.device_score_weights
    assert ssn.device_dynamic_gates == jax_ssn.device_dynamic_gates == {"pod_count"}
    jax_eng, eng = _engine("scheduler_tpu", jax_ssn), _engine("scheduler_tpu_torch", ssn)
    assert eng.use_static and jax_eng.use_static
    assert eng.st.nodes.names == jax_eng.st.nodes.names
    nb, tb = eng.n_bucket, eng._t_bucket
    jax_mask, jax_score = (np.asarray(a) for a in jax_build(jax_ssn, jax_eng.st, nb, tb))
    mask, score = build_static_tensors_device(ssn, eng.st, nb, tb, torch.device("cpu"))
    t, n = eng.flat_count, eng.st.nodes.count
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
    np.testing.assert_array_equal(score.numpy().view(np.int32), jax_score.view(np.int32))
    # Not vacuous: every kind of static constraint cuts pairs, and the
    # preferred-affinity score is live.
    assert 0 < int(mask[:t, :n].sum()) < t * n
    assert not mask[:, eng.st.nodes.names.index("n03")].any(), "unschedulable node"
    assert not mask[:, eng.st.nodes.names.index("n04")].any(), "not-ready node"
    assert not mask[:, eng.st.nodes.names.index("n05")].any(), "memory-pressured node"
    assert float(score.max()) > 0.0


def _predicate_outcomes(pkg):
    ssn = _session(pkg)
    out = {}
    for job in ssn.jobs.values():
        for task in job.tasks.values():
            for node in ssn.nodes.values():
                try:
                    ssn.predicate_fn(task, node)
                    out[(task.name, node.name)] = None
                except Exception as exc:  # FitError of either package
                    out[(task.name, node.name)] = str(exc)
    return out


def test_host_predicate_matches_jax():
    port, jax = _predicate_outcomes("scheduler_tpu_torch"), _predicate_outcomes("scheduler_tpu")
    assert port == jax
    reasons = {msg.split(": ", 1)[1] for msg in port.values() if msg}
    assert {"node(s) were unschedulable", "node(s) had MemoryPressure",
            "node(s) didn't match node selector",
            "node(s) had taints that the pod didn't tolerate"} <= reasons
    assert any(msg is None for msg in port.values())


# -- a plugin the port does not carry ------------------------------------------------

@pytest.mark.parametrize("plugin", ["proportion", "conformance"])
def test_unported_plugin_raises(plugin, monkeypatch):
    """A builtin of the JAX package with no builder registered in the port
    raises at session open (every builtin is ported now, so the test takes
    one out of the port's registry)."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import open_session, registry
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    builders = dict(registry._plugin_builders)
    del builders[plugin]
    monkeypatch.setattr(registry, "_plugin_builders", builders)

    conf = parse_scheduler_conf(
        f'actions: "allocate"\ntiers:\n- plugins:\n  - name: gang\n  - name: {plugin}\n')
    with pytest.raises(NotImplementedError, match=plugin):
        open_session(make_synthetic_cluster(4, 20, tasks_per_job=5).cache, conf.tiers,
                     device="cpu")


def test_unknown_plugin_is_logged_and_skipped():
    """A name neither package knows keeps the reference's log-and-skip."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import open_session
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    conf = parse_scheduler_conf(
        'actions: "allocate"\ntiers:\n- plugins:\n  - name: gang\n  - name: no-such-plugin\n')
    ssn = open_session(make_synthetic_cluster(4, 20, tasks_per_job=5).cache, conf.tiers,
                       device="cpu")
    assert set(ssn.plugins) == {"gang"}
