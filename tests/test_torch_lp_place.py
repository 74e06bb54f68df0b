"""The port's LP-relaxed allocator (``SCHEDULER_TORCH_ALLOCATOR=lp``) against
the JAX package's (``SCHEDULER_TPU_ALLOCATOR=lp``), on the CPU.

* the twin of every case of ``tests/test_lp_place.py`` but its mesh cases
  (feasibility, gang atomicity, the queue-share chain, static predicates,
  binds within ``LP_BIND_TOLERANCE`` of greedy, determinism, the greedy
  default, the engine cache, the memory-limit fallback, the quality
  block), each also held to the JAX engine's codes and evidence;
* the plain relaxation (``lp_place.lp_relax`` on CPU tensors) against the
  JAX ``lp_relax`` on seeded operands, per task and per class: the
  marginals within ``MARGINAL_ATOL``, the feasibility, ``pref`` and the
  evidence row equal;
* the repair alone, fed the JAX relaxation's marginals and feasibility:
  codes bit for bit the JAX engine's;
* the admission gate's decisions and reasons equal to JAX's over a grid.

The JAX side of the sessions with proportion runs ``SCHEDULER_TPU_QFAIR=
host`` (its device water-fill imports ``jax.experimental.enable_x64``,
which this jax lacks); the port's device water-fill is bit for bit the
host one.
"""

import importlib

import numpy as np
import pytest
import torch

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import LP_BIND_TOLERANCE, lp_operands, lp_spec, spec_cluster

BINPACK_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
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

JAX, PORT = "scheduler_tpu", "scheduler_tpu_torch"
FLAG = {JAX: "SCHEDULER_TPU_", PORT: "SCHEDULER_TORCH_"}


def jax_words(reason):
    """A port reason in the JAX package's words: its flags carry the port's prefix."""
    return reason if reason is None else reason.replace(FLAG[PORT], FLAG[JAX])

# The plain relaxation against the JAX one: the load sums run in another
# order (torch's matmul against XLA's dot), so each iteration's projection
# differs in the last bits, and 200 iterations carry those bits into log_v.
# Measured on these operands: up to 3e-5 on marginals of tight class rows
# (class counts to 400 make large loads), 4e-6 per task.
MARGINAL_ATOL = 1e-4

OPERAND_NAMES = ("idle", "allocatable", "task_count", "pods_limit", "node_gate",
                 "static_mask", "static_score", "mins", "init_resreq", "resreq")


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


def _session(pkg, spec, conf_text):
    cache = spec_cluster(spec, pkg)
    conf = importlib.import_module(f"{pkg}.conf").parse_scheduler_conf(conf_text)
    framework = importlib.import_module(f"{pkg}.framework")
    kw = {"device": "cpu"} if pkg == PORT else {}
    return framework.open_session(cache, conf.tiers, **kw)


def _engine(monkeypatch, pkg, ssn, flavor="lp", **env):
    """The package's fused engine over the session's allocate candidates,
    with ``<prefix>ALLOCATOR`` at ``flavor`` and ``<prefix><key>`` for each
    of ``env``."""
    monkeypatch.setenv(FLAG[pkg] + "ALLOCATOR", flavor)
    for k, v in env.items():
        monkeypatch.setenv(FLAG[pkg] + k, str(v))
    acts = importlib.import_module(f"{pkg}.actions.allocate")
    fused = importlib.import_module(f"{pkg}.ops.fused")
    kw = {"device": "cpu"} if pkg == PORT else {}
    return fused.FusedAllocator(ssn, acts.collect_candidates(ssn), **kw)


def _run(eng):
    codes = eng._execute() if hasattr(eng, "_execute") else eng.readback()
    return np.asarray(codes).copy()[:eng.flat_count]


def _close(pkg, ssn):
    importlib.import_module(f"{pkg}.framework").close_session(ssn)


def _both(monkeypatch, spec, conf_text, flavor="lp", **env):
    """The JAX and the port engine on twin sessions of ``spec``: ((codes,
    run_stats, engine) of each)."""
    out = []
    for pkg in (JAX, PORT):
        ssn = _session(pkg, spec, conf_text)
        try:
            eng = _engine(monkeypatch, pkg, ssn, flavor, **env)
            codes = _run(eng)
            out.append((codes, eng.run_stats(), eng))
        finally:
            _close(pkg, ssn)
    return out


def _assert_feasible(engine, codes):
    """No node ledger oversubscribed and no pod-count limit passed, on the
    engine's own snapshot."""
    t = engine.flat_count
    codes = codes[:t]
    st = engine.st
    req = st.tasks.resreq[:t]
    placed = codes >= 0
    load = np.zeros_like(st.nodes.idle)
    counts = np.zeros(st.nodes.count, dtype=np.int64)
    if placed.any():
        np.add.at(load, codes[placed], req[placed])
        np.add.at(counts, codes[placed], 1)
    assert (load <= st.nodes.idle + 1e-6).all(), "node ledger oversubscribed"
    assert (counts <= st.nodes.pods_limit - st.nodes.task_count).all(), "pod limit passed"
    return placed


def _assert_lp_equal(port_stats, jax_stats):
    assert port_stats["engine"] == jax_stats["engine"] == "lp"
    assert port_stats["lp"] == jax_stats["lp"]


# -- feasibility, gang and queue invariants ---------------------------------------

def test_lp_engages_and_respects_capacity(monkeypatch):
    (jc, js, _), (codes, stats, eng) = _both(monkeypatch, lp_spec(), BINPACK_CONF)
    assert eng.allocator == "lp" and eng.use_lp, eng.lp_reason
    assert not eng.use_mega and not eng.step_kernel and eng.engine == "lp"
    placed = _assert_feasible(eng, codes)
    assert placed.sum() == eng.flat_count
    lp = stats["lp"]
    for key in ("iterations", "converged_at", "binds", "fragmentation", "drf_distance",
                "repair_fallbacks"):
        assert key in lp, key
    assert lp["binds"] == int(placed.sum()) and lp["iterations"] == 200
    assert (codes == jc).all()
    _assert_lp_equal(stats, js)


def test_lp_gang_atomicity_under_tight_capacity(monkeypatch):
    """Room for two of four 5-pod gangs: each gang places whole or not."""
    spec = lp_spec(n_nodes=2, node_cpu=5 * 900 + 100)
    (jc, js, _), (codes, stats, eng) = _both(monkeypatch, spec, BINPACK_CONF)
    assert eng.use_lp, eng.lp_reason
    _assert_feasible(eng, codes)
    base, total = 0, 0
    for job, rows in zip(eng.jobs, eng.job_rows):
        n = len(rows)
        placed = int((codes[base:base + n] >= 0).sum())
        assert placed == 0 or placed >= job.min_available, job.uid
        total += placed
        base += n
    assert total == 10
    assert (codes == jc).all()
    _assert_lp_equal(stats, js)


def _per_queue(engine, codes):
    out, base = {}, 0
    for job, rows in zip(engine.jobs, engine.job_rows):
        n = len(rows)
        out[job.queue] = out.get(job.queue, 0) + int((codes[base:base + n] >= 0).sum())
        base += n
    return out


def test_lp_respects_queue_share_chain(monkeypatch):
    """Two weighted queues under proportion: the repair pops queues by the
    same share and overused chain as greedy, so each queue binds what it
    binds under greedy."""
    spec = lp_spec(queues=("qa", "qbb"), n_nodes=2, node_cpu=5 * 900 + 100)
    ssn = _session(PORT, spec, MULTIQ_CONF)
    try:
        greedy = _engine(monkeypatch, PORT, ssn, "greedy")
        codes_g = _run(greedy)
    finally:
        _close(PORT, ssn)
    (jc, js, _), (codes, stats, eng) = _both(monkeypatch, spec, MULTIQ_CONF)
    assert eng.use_lp, eng.lp_reason
    _assert_feasible(eng, codes)
    assert _per_queue(eng, codes) == _per_queue(greedy, codes_g)
    assert stats["queue_chain"]["queues"] == 2
    assert (codes == jc).all()
    _assert_lp_equal(stats, js)


def test_lp_respects_session_static_predicates(monkeypatch):
    """Predicates and nodeorder build static rows: the LP feasibility and the
    repair's mask carry them, so every placement passes the task's mask."""
    from scheduler_tpu_torch.ops.allocator import build_static_tensors_device

    spec = lp_spec(n_nodes=6, n_gangs=3, gang_size=4, req_cpu=700, selectors=True)
    spec["nodes"] = [(name, dict(alloc, memory=32 * 2.0**30), extra)
                     for name, alloc, extra in spec["nodes"]]
    (jc, js, _), (codes, stats, eng) = _both(monkeypatch, spec, STATIC_CONF)
    assert eng.use_lp and eng.use_static, eng.lp_reason
    _assert_feasible(eng, codes)
    t = eng.flat_count
    mask, _ = build_static_tensors_device(eng.ssn, eng.st, eng.n_bucket, eng._t_bucket, "cpu")
    mask = mask.numpy()[:t]
    placed = codes >= 0
    assert placed.sum() == t
    assert mask[np.arange(t)[placed], codes[placed]].all()
    assert (codes == jc).all()
    _assert_lp_equal(stats, js)


# -- quality (the bench gate's contract, small) --------------------------------------

def test_bind_tolerance_is_the_gate():
    from scripts.bench_gate import LP_BIND_TOLERANCE as GATE

    assert LP_BIND_TOLERANCE == GATE


@pytest.mark.parametrize("n_nodes,node_cpu", [(8, 4000), (3, 5 * 900 + 100)])
def test_lp_binds_within_tolerance_of_greedy(monkeypatch, n_nodes, node_cpu):
    spec = lp_spec(n_nodes=n_nodes, node_cpu=node_cpu)
    ssn = _session(PORT, spec, BINPACK_CONF)
    try:
        binds_greedy = int((_run(_engine(monkeypatch, PORT, ssn, "greedy")) >= 0).sum())
        lp = _engine(monkeypatch, PORT, ssn, "lp")
        assert lp.use_lp, lp.lp_reason
        codes = _run(lp)
        _assert_feasible(lp, codes)
    finally:
        _close(PORT, ssn)
    assert int((codes >= 0).sum()) >= (1.0 - LP_BIND_TOLERANCE) * binds_greedy


# -- determinism --------------------------------------------------------------

def test_lp_bitwise_deterministic_across_runs(monkeypatch):
    ssn = _session(PORT, lp_spec(n_nodes=3, node_cpu=5 * 900 + 100), BINPACK_CONF)
    try:
        eng = _engine(monkeypatch, PORT, ssn)
        a = _run(eng)
        eng._dev = eng._encoded = None
        b = _run(eng)
        c = _run(_engine(monkeypatch, PORT, ssn))
    finally:
        _close(PORT, ssn)
    assert (a == b).all() and (a == c).all()


# -- the greedy default ---------------------------------------------------------------

def test_default_flavor_is_greedy_and_stages_no_lp_state(monkeypatch):
    monkeypatch.delenv("SCHEDULER_TORCH_ALLOCATOR", raising=False)
    ssn = _session(PORT, lp_spec(), BINPACK_CONF)
    try:
        from scheduler_tpu_torch.actions.allocate import collect_candidates
        from scheduler_tpu_torch.ops.fused import FusedAllocator

        eng = FusedAllocator(ssn, collect_candidates(ssn), device="cpu")
        assert eng.allocator == "greedy" and not eng.use_lp
        assert eng._lp_stats_host is None and eng._lp_static is None
        assert eng.use_mega
        eng.readback()
        stats = eng.run_stats()
        assert "lp" not in stats and stats["engine"] == "mega"
    finally:
        _close(PORT, ssn)


def test_greedy_codes_identical_with_and_without_lp(monkeypatch):
    ssn = _session(PORT, lp_spec(), BINPACK_CONF)
    try:
        from scheduler_tpu_torch.actions.allocate import collect_candidates
        from scheduler_tpu_torch.ops.fused import FusedAllocator

        monkeypatch.delenv("SCHEDULER_TORCH_ALLOCATOR", raising=False)
        default = FusedAllocator(ssn, collect_candidates(ssn), device="cpu")
        codes_default = _run(default)
        explicit = _engine(monkeypatch, PORT, ssn, "greedy")
        assert default.use_mega == explicit.use_mega
        assert (codes_default == _run(explicit)).all()
        _run(_engine(monkeypatch, PORT, ssn, "lp"))
        assert (_run(_engine(monkeypatch, PORT, ssn, "greedy")) == codes_default).all()
    finally:
        _close(PORT, ssn)


def test_engine_cache_never_serves_a_stale_flavor(monkeypatch):
    """The flavor and every LP knob are in ``_ENV_KEYS`` (a flip misses),
    and ``_delta_compatible`` re-checks the flavor for direct callers."""
    from scheduler_tpu_torch.ops.engine_cache import _ENV_KEYS

    for key in ("ALLOCATOR", "LP_ITERS", "LP_TAU", "LP_TOL", "LP_LIMIT"):
        assert "SCHEDULER_TORCH_" + key in _ENV_KEYS, key
    ssn = _session(PORT, lp_spec(), BINPACK_CONF)
    try:
        eng = _engine(monkeypatch, PORT, ssn, "greedy")
        assert eng._delta_compatible(ssn)
        monkeypatch.setenv("SCHEDULER_TORCH_ALLOCATOR", "lp")
        assert not eng._delta_compatible(ssn)
    finally:
        _close(PORT, ssn)


def test_flavor_flips_across_engine_cache_cycles(monkeypatch):
    """Cycles through the engine cache on a session whose layout never moves
    (one node, gangs that cannot place: nothing binds): the engine each
    cycle runs is the flag's flavor, hit or miss."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, get_action, open_session
    from scheduler_tpu_torch.ops import engine_cache
    from scheduler_tpu_torch.utils import phases

    cache = spec_cluster(lp_spec(n_nodes=1))
    conf = parse_scheduler_conf(BINPACK_CONF)
    engine_cache.clear()
    seen = []
    try:
        for flavor in ("greedy", "greedy", "lp", "lp", "greedy", "lp"):
            monkeypatch.setenv("SCHEDULER_TORCH_ALLOCATOR", flavor)
            phases.begin()
            ssn = open_session(cache, conf.tiers, device="cpu")
            get_action("allocate").execute(ssn)
            close_session(ssn)
            notes = phases.take_notes()
            phases.end()
            seen.append((notes["cohort"]["engine"], notes["engine_cache"]))
    finally:
        engine_cache.clear()
    assert not cache.binder.binds
    assert [e for e, _ in seen] == ["mega", "mega", "lp", "lp", "mega", "lp"]
    assert [o for _, o in seen] == ["miss", "hit", "miss", "hit", "hit", "hit"]


# -- the fallback gate -------------------------------------------------------------

def test_lp_falls_back_to_greedy_over_the_memory_limit(monkeypatch):
    (jc, js, jeng), (codes, stats, eng) = _both(monkeypatch, lp_spec(), BINPACK_CONF,
                                                LP_LIMIT=1)
    assert eng.allocator == "lp" and not eng.use_lp
    assert jax_words(eng.lp_reason) == jeng.lp_reason
    assert "SCHEDULER_TORCH_LP_LIMIT" in eng.lp_reason
    assert stats["engine"] == "mega" and "lp" not in stats
    _assert_feasible(eng, codes)
    assert (codes == jc).all()


@pytest.mark.parametrize("limit", [None, 1, 2048, 256 * 1024 * 1024])
def test_lp_supported_matches_jax(monkeypatch, limit):
    from scheduler_tpu.ops import lp_place as jax_lp
    from scheduler_tpu_torch.ops import lp_place

    for pkg in (JAX, PORT):
        if limit is None:
            monkeypatch.delenv(FLAG[pkg] + "LP_LIMIT", raising=False)
        else:
            monkeypatch.setenv(FLAG[pkg] + "LP_LIMIT", str(limit))
    for flat in (0, 5, 100_000):
        for releasing in (False, True):
            for rows in (8, 1024, 8192, 131_072):
                for nb in (8, 1024, 16_384):
                    ok, reason = lp_place.lp_supported(flat, releasing, rows, nb)
                    want = jax_lp.lp_supported(flat, releasing, rows, nb, None)
                    assert (ok, jax_words(reason)) == want, (flat, releasing, rows, nb)
                    assert lp_place.lp_working_set_bytes(rows, nb) == \
                        jax_lp.lp_working_set_bytes(rows, nb, 1)


def test_lp_quality_block_fields():
    from scheduler_tpu_torch.ops.lp_place import lp_quality

    idle = np.asarray([[3.0, 8.0]])
    out = lp_quality(np.asarray([0, -2], np.int32), np.asarray([0, 0], np.int32),
                     np.asarray([[2.0, 1.0], [2.0, 1.0]]), idle, np.asarray([0, 0], np.int32),
                     idle)
    assert out == {"binds": 1, "repair_fallbacks": 0, "fragmentation": 0.0,
                   "drf_distance": 0.0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lp_quality_matches_jax(seed):
    from scheduler_tpu.ops.lp_place import lp_quality as jax_quality
    from scheduler_tpu_torch.ops.lp_place import lp_quality

    rng = np.random.default_rng(seed)
    t, n, r = 200, 16, 3
    codes = rng.integers(-2, n, t).astype(np.int32)
    pref = rng.integers(0, n, t).astype(np.int32)
    req = rng.uniform(0.1, 2.0, (t, r))
    idle = rng.uniform(5.0, 40.0, (n, r))
    job = np.sort(rng.integers(0, 30, t)).astype(np.int32)
    alloc = idle + rng.uniform(0.0, 10.0, (n, r))
    assert lp_quality(codes, pref, req, idle, job, alloc) == \
        jax_quality(codes, pref, req, idle, job, alloc)


# -- the relaxation against JAX's -------------------------------------------------------

@pytest.mark.parametrize("seed,rows,n,r_dim,classes,pod_count,static,tight", [
    (0, 64, 48, 2, False, True, True, True),
    (1, 40, 100, 3, True, True, True, True),
    (2, 128, 64, 2, False, False, False, True),
    (3, 32, 256, 4, True, False, True, True),
    (4, 16, 64, 2, False, True, True, False),
])
def test_plain_relaxation_matches_jax(seed, rows, n, r_dim, classes, pod_count, static, tight):
    import jax.numpy as jnp

    from scheduler_tpu.ops import lp_place as jax_lp
    from scheduler_tpu_torch.ops import lp_place

    ops = lp_operands(seed, rows, n, r_dim, classes=classes, pod_count=pod_count,
                      static=static, tight=tight)
    kw = dict(iters=200, tau=0.25, tol=1e-3, **ops["flags"])
    count = ops["class_count"]
    want = jax_lp.lp_relax(*[jnp.asarray(ops[k]) for k in OPERAND_NAMES],
                           None if count is None else jnp.asarray(count), **kw)
    got = lp_place.lp_relax(*[torch.as_tensor(ops[k]) for k in OPERAND_NAMES],
                            None if count is None else torch.as_tensor(count), **kw)
    x_w, feas_w, pref_w, raw_w = (np.asarray(a) for a in want)
    x_g, feas_g, pref_g, raw_g = (a.numpy() for a in got)
    assert x_g.dtype == np.float32 and x_g.shape == x_w.shape
    np.testing.assert_allclose(x_g, x_w, rtol=0, atol=MARGINAL_ATOL)
    assert (feas_g == feas_w).all()
    assert (pref_g == pref_w).all()
    assert (raw_g == raw_w).all()
    assert raw_g[0] == 200 and (raw_g[1] >= 0) == (not tight)


# -- the repair alone ------------------------------------------------------------------

REPAIR_CASES = {
    "slack": (lp_spec(), BINPACK_CONF, {}),
    "tight": (lp_spec(n_nodes=3, node_cpu=5 * 900 + 100), BINPACK_CONF, {}),
    "tight_tasks": (lp_spec(n_nodes=3, node_cpu=5 * 900 + 100), BINPACK_CONF,
                    {"SIG_COMPRESS": "off"}),
    "queues": (lp_spec(queues=("qa", "qbb"), n_nodes=2, node_cpu=5 * 900 + 100), MULTIQ_CONF,
               {}),
    "static": (lp_spec(n_nodes=6, n_gangs=3, gang_size=4, req_cpu=700, selectors=True),
               STATIC_CONF, {}),
    "static_classes": (lp_spec(n_nodes=6, n_gangs=3, gang_size=4, req_cpu=700,
                               selectors=True), STATIC_CONF, {"SIG_COMPRESS": "on"}),
    "unique": (lp_spec(n_nodes=3, node_cpu=5 * 900 + 100, unique_reqs=True), BINPACK_CONF, {}),
}


def _jax_relaxation(eng):
    """The JAX engine's relaxation outputs on its own operands, as its
    ``_dispatch_lp`` calls ``lp_relax``."""
    from scheduler_tpu.ops import lp_place as jax_lp

    args = eng.args
    if eng.sig_compress and eng._lp_sig_host is not None:
        rows = tuple(eng._lp_class_dev())
    else:
        rows = (args[7], args[8])
    out = jax_lp.lp_relax(args[0], args[3], args[2], args[4], args[5], args[9], args[10],
                          args[6], *rows, **eng._lp_kw())
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_repair_on_jax_marginals_matches_jax(monkeypatch, case):
    """Fed the JAX relaxation's marginals and feasibility, the port's repair
    (the loop on its XLA step arm) gives the JAX engine's codes bit for
    bit; end to end the port's codes and lp block equal JAX's too."""
    from scheduler_tpu_torch.ops import lp_place

    spec, conf_text, env = REPAIR_CASES[case]
    ssn = _session(JAX, spec, conf_text)
    try:
        jeng = _engine(monkeypatch, JAX, ssn, **env)
        assert jeng.use_lp, jeng.lp_reason
        relaxed = _jax_relaxation(jeng)
        want = _run(jeng)
        want_stats = jeng.run_stats()
    finally:
        _close(JAX, ssn)
    real = lp_place.lp_relax
    fed = []

    def jax_marginals(*args, **kw):
        got = real(*args, **kw)
        assert got[0].shape == relaxed[0].shape and (got[1].numpy() == relaxed[1]).all()
        fed.append(np.abs(got[0].numpy() - relaxed[0]).max())
        return tuple(torch.from_numpy(np.array(a)) for a in relaxed)

    for repair_only in (True, False):
        ssn = _session(PORT, spec, conf_text)
        try:
            with monkeypatch.context() as m:
                if repair_only:
                    m.setattr(lp_place, "lp_relax", jax_marginals)
                eng = _engine(monkeypatch, PORT, ssn, **env)
                assert eng.use_lp and eng.sig_compress == jeng.sig_compress
                got = _run(eng)
                stats = eng.run_stats()
        finally:
            _close(PORT, ssn)
        assert (got == want).all(), (case, repair_only)
        _assert_lp_equal(stats, want_stats)
        assert stats.get("sig") == want_stats.get("sig")
    assert fed and fed[0] <= MARGINAL_ATOL
