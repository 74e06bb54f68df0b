"""Signature classes in the port (``SCHEDULER_TORCH_SIG_COMPRESS``) against the
JAX package's (``SCHEDULER_TPU_SIG_COMPRESS``), on the CPU.

* the mode switch and its default;
* the ``sig`` evidence block of ``FusedAllocator.run_stats()`` equal to
  JAX's on greedy and on LP sessions, engaged or with its reason;
* greedy codes the same under ``off``, ``on`` and ``auto`` (and JAX's);
* LP codes with classes equal to LP codes without them, and LP binds on
  classes equal to the per-task binds (JAX's
  ``test_lp_class_iteration_matches_per_task_binds``);
* the class working set is what the LP gate sizes (JAX's
  ``test_lp_limit_flip_fallback_to_native``);
* a resident engine never serves a stale mode.

The JAX side runs ``SCHEDULER_TPU_QFAIR=host`` (its device water-fill
imports ``jax.experimental.enable_x64``, which this jax lacks).
"""

import importlib

import numpy as np
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import lp_spec, spec_cluster

BINPACK_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: binpack
"""

MULTIQ_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: proportion
  - name: binpack
"""

STATIC_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: predicates
  - name: nodeorder
"""

JAX, PORT = "scheduler_tpu", "scheduler_tpu_torch"
FLAG = {JAX: "SCHEDULER_TPU_", PORT: "SCHEDULER_TORCH_"}

SESSIONS = {
    "duplicates": (lp_spec(), BINPACK_CONF),
    "unique": (lp_spec(unique_reqs=True), BINPACK_CONF),
    "tight": (lp_spec(n_nodes=2, node_cpu=5 * 900 + 100), BINPACK_CONF),
    "queues": (lp_spec(queues=("qa", "qbb"), n_nodes=2, node_cpu=5 * 900 + 100), MULTIQ_CONF),
    "static": (lp_spec(n_nodes=6, n_gangs=3, gang_size=4, req_cpu=700, selectors=True),
               STATIC_CONF),
}


@pytest.fixture(autouse=True)
def _jax_host_water_fill(monkeypatch):
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "host")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The relaxation's plain version is 200 rounds of small tensor
    operations: on one thread each, so that test workers sharing the
    machine's cores do not each fan every operation out over all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codes(monkeypatch, pkg, spec, conf_text, sig, flavor="greedy", **env):
    """One engine of ``pkg`` on a fresh cluster of ``spec``: (codes,
    run_stats, engine)."""
    monkeypatch.setenv(FLAG[pkg] + "SIG_COMPRESS", sig)
    monkeypatch.setenv(FLAG[pkg] + "ALLOCATOR", flavor)
    for k, v in env.items():
        monkeypatch.setenv(FLAG[pkg] + k, str(v))
    cache = spec_cluster(spec, pkg)
    conf = importlib.import_module(f"{pkg}.conf").parse_scheduler_conf(conf_text)
    framework = importlib.import_module(f"{pkg}.framework")
    acts = importlib.import_module(f"{pkg}.actions.allocate")
    fused = importlib.import_module(f"{pkg}.ops.fused")
    kw = {"device": "cpu"} if pkg == PORT else {}
    ssn = framework.open_session(cache, conf.tiers, **kw)
    try:
        eng = fused.FusedAllocator(ssn, acts.collect_candidates(ssn), **kw)
        codes = eng._execute() if pkg == JAX else eng.readback()
        return np.asarray(codes).copy()[:eng.flat_count], eng.run_stats(), eng
    finally:
        framework.close_session(ssn)


def test_mode_switch(monkeypatch):
    from scheduler_tpu_torch.ops.sig_compress import sig_compress_mode

    monkeypatch.delenv("SCHEDULER_TORCH_SIG_COMPRESS", raising=False)
    assert sig_compress_mode() == "auto"
    for mode in ("off", "on", "auto"):
        monkeypatch.setenv("SCHEDULER_TORCH_SIG_COMPRESS", mode)
        assert sig_compress_mode() == mode
    monkeypatch.setenv("SCHEDULER_TORCH_SIG_COMPRESS", "sometimes")
    assert sig_compress_mode() == "auto"


def test_sig_stats_block():
    from scheduler_tpu.ops.sig_compress import sig_stats as jax_stats
    from scheduler_tpu_torch.ops.sig_compress import sig_stats

    for args in ((2, 20, 3072), (7, 7, 0), (0, 0, 0), (3, 100_000, 10**9)):
        assert sig_stats(*args) == jax_stats(*args)


@pytest.mark.parametrize("flavor", ["greedy", "lp"])
@pytest.mark.parametrize("sig", ["off", "on", "auto"])
@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_sig_block_and_codes_match_jax(monkeypatch, session, sig, flavor):
    """The ``sig`` block (or its absence under ``off``) and the codes equal
    the JAX engine's on the same session."""
    spec, conf_text = SESSIONS[session]
    want, want_stats, jeng = _codes(monkeypatch, JAX, spec, conf_text, sig, flavor)
    got, stats, eng = _codes(monkeypatch, PORT, spec, conf_text, sig, flavor)
    assert eng.sig_mode == jeng.sig_mode == sig
    assert eng.sig_compress == jeng.sig_compress
    assert eng.sig_classes == jeng.sig_classes
    assert eng.use_lp == jeng.use_lp == (flavor == "lp")
    assert stats.get("sig") == want_stats.get("sig")
    assert ("sig" in stats) == (sig != "off")
    assert (got == want).all()
    if flavor == "lp":
        assert stats["lp"] == want_stats["lp"]


def test_auto_refuses_all_unique_and_on_forces_it(monkeypatch):
    spec, conf_text = SESSIONS["unique"]
    _, stats_auto, eng_auto = _codes(monkeypatch, PORT, spec, conf_text, "auto")
    assert not eng_auto.sig_compress
    assert stats_auto["sig"] == {"engaged": False, "reason": "no repeated signatures (S == T)"}
    codes_on, stats_on, eng_on = _codes(monkeypatch, PORT, spec, conf_text, "on")
    assert eng_on.sig_compress and eng_on.sig_classes == eng_on.flat_count
    assert stats_on["sig"]["compression"] == 1.0
    codes_off, stats_off, _ = _codes(monkeypatch, PORT, spec, conf_text, "off")
    assert (codes_on == codes_off).all()
    assert "sig" not in stats_off


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_greedy_codes_the_same_in_every_mode(monkeypatch, session):
    spec, conf_text = SESSIONS[session]
    codes = [_codes(monkeypatch, PORT, spec, conf_text, sig)[0] for sig in ("off", "on", "auto")]
    assert (codes[0] == codes[1]).all() and (codes[0] == codes[2]).all()


@pytest.mark.parametrize("session", ["duplicates", "tight", "queues", "static"])
def test_lp_codes_with_classes_equal_codes_without(monkeypatch, session):
    spec, conf_text = SESSIONS[session]
    codes_on, _, eng_on = _codes(monkeypatch, PORT, spec, conf_text, "on", "lp")
    codes_off, _, eng_off = _codes(monkeypatch, PORT, spec, conf_text, "off", "lp")
    assert eng_on.use_lp and eng_on.sig_compress and not eng_off.sig_compress
    assert eng_on.sig_classes < eng_on.flat_count
    assert (codes_on == codes_off).all()


def test_lp_class_iteration_matches_per_task_binds(monkeypatch):
    spec, conf_text = SESSIONS["tight"]
    codes_on, stats_on, _ = _codes(monkeypatch, PORT, spec, conf_text, "on", "lp")
    codes_off, stats_off, _ = _codes(monkeypatch, PORT, spec, conf_text, "off", "lp")
    assert (codes_on >= 0).sum() == (codes_off >= 0).sum() == 10
    assert stats_on["lp"]["binds"] == stats_off["lp"]["binds"]


def test_lp_limit_flip_fallback_to_native(monkeypatch):
    """8 nodes (nb 8), 20 tasks (tb 32) in 1 class (sb 8): the working sets
    are 4,096 bytes per task and 1,024 on classes, so a 2,048-byte limit
    declines the per-task relaxation and admits the class one."""
    spec, conf_text = SESSIONS["duplicates"]
    _, stats_off, eng_off = _codes(monkeypatch, PORT, spec, conf_text, "off", "lp",
                                   LP_LIMIT=2048)
    assert not eng_off.use_lp and "SCHEDULER_TORCH_LP_LIMIT" in eng_off.lp_reason
    codes_on, stats_on, eng_on = _codes(monkeypatch, PORT, spec, conf_text, "on", "lp",
                                        LP_LIMIT=2048)
    assert eng_on.sig_compress and eng_on.use_lp, eng_on.lp_reason
    assert stats_on["engine"] == "lp" and stats_off["engine"] == "mega"
    assert (codes_on >= 0).sum() == eng_on.flat_count


def test_class_operands_pad_with_zero_count(monkeypatch):
    """The [S]-class LP operands are padded to bucket(S) rows with zero
    count (pad classes carry no load), and each class row is its first
    task's request."""
    spec, conf_text = SESSIONS["static"]
    _, _, eng = _codes(monkeypatch, PORT, spec, conf_text, "on", "lp")
    init_c, req_c, count_c = eng._lp_sig_host
    s = eng.sig_classes
    assert count_c.shape == (eng._sig_bucket,) and (count_c[s:] == 0).all()
    assert count_c[:s].tolist() == eng.class_count.tolist()
    assert int(count_c.sum()) == eng.flat_count
    first = [int(np.flatnonzero(eng.sig_of_task == c)[0]) for c in range(s)]
    assert eng._lp_rep_rows[:s].tolist() == first


def test_engine_cache_rejects_stale_sig_mode(monkeypatch):
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.ops.engine_cache import _ENV_KEYS
    from scheduler_tpu_torch.ops.fused import FusedAllocator
    from scheduler_tpu_torch.actions.allocate import collect_candidates

    assert "SCHEDULER_TORCH_SIG_COMPRESS" in _ENV_KEYS
    monkeypatch.setenv("SCHEDULER_TORCH_SIG_COMPRESS", "on")
    cache = spec_cluster(lp_spec())
    ssn = open_session(cache, parse_scheduler_conf(BINPACK_CONF).tiers, device="cpu")
    try:
        eng = FusedAllocator(ssn, collect_candidates(ssn), device="cpu")
        assert eng.sig_compress and eng._delta_compatible(ssn)
        monkeypatch.setenv("SCHEDULER_TORCH_SIG_COMPRESS", "off")
        assert not eng._delta_compatible(ssn)
        monkeypatch.setenv("SCHEDULER_TORCH_SIG_COMPRESS", "on")
        assert eng._delta_compatible(ssn)
    finally:
        close_session(ssn)
