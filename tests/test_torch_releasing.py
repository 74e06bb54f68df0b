"""Releasing capacity in the port against the JAX package, on the CPU.

A session whose evicted pods still hold RELEASING capacity runs the mega
kernel's releasing mode: a task fits on idle or releasing; on releasing
alone it is PIPELINED (code ``-3 - node``).  On CPU tensors ``mega_allocate``
runs its plain version (``mega_allocate_reference``).  Held to the JAX
package on the same inputs, made from a seed with numpy (tolerance: none;
codes, stats, statuses and FitErrors bitwise or word for word):

* the plain version against the JAX ``mega_allocate`` in interpret mode on
  synthetic releasing operands (``chip_smoke.mega_operands(releasing=True)``)
  in its four modes (cursor, static rows, multi-queue, multi-queue with
  static rows), with an idle-fit node and a releasing-only node on equal
  scores (either first), releasing-only nodes that score best, and nodes at
  their pod limits;
* the engine on twins of the JAX tests' releasing sessions
  (``tests/test_megakernel.py``'s mid-evict session as
  ``chip_smoke.mid_evict_cluster``, ``tests/test_fused.py``'s
  ``build_releasing_cluster``): operands, codes, binds and PIPELINED
  statuses, and the port's host loop;
* the slice: ``harness.make_reclaim_aftermath_cluster`` (BASELINE config 4
  after its reclaim) at scale 0.02 and its JAX twin through
  ``Scheduler.run_once`` and through one allocate action: binds, pipelined
  tasks, statuses, FitErrors, node ledgers, proportion's queue attributes
  and ``run_stats()`` key for key but the wall time;
* a releasing session that the mega gate closes: the loop's releasing arm;
* the launch plan with the releasing rows, and the refusal that stays loud.

The JAX side runs proportion's default device water-fill, which needs
``jax.experimental.enable_x64``: this jax lacks it, and each test here
substitutes ``jax.enable_x64`` (an autouse fixture of this module only).
"""

import copy
import importlib

import jax
import jax.experimental
import numpy as np
import pytest

import chip_smoke as smoke
from scheduler_tpu.ops.megakernel import mega_allocate as jax_mega
from scheduler_tpu_torch.interop import mega_operands_from_numpy
from scheduler_tpu_torch.ops import megakernel as mk
from tests.test_torch_megakernel import JaxFused, TorchFused, jax_candidates, torch_candidates

GIB = 2.0**30
TS0 = 1_700_000_000.0
PKGS = ("scheduler_tpu", "scheduler_tpu_torch")

# tests/test_megakernel.py's BENCH_CONF and tests/test_fused.py's
# CONF_PROPORTION.
BENCH_CONF = smoke.FLAGSHIP_CONF
PROPORTION_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: proportion
  - name: binpack
"""


@pytest.fixture(autouse=True)
def _enable_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _modules(pkg):
    return (importlib.import_module(f"{pkg}.apis.objects"),
            importlib.import_module(f"{pkg}.api.vocab"),
            importlib.import_module(f"{pkg}.cache.cache"))


class _Twin:
    """A cache of package ``pkg`` whose objects take creation times in the
    order they are made, one microsecond apart (as ``tests/fixtures.py``)."""

    def __init__(self, pkg):
        self.objects, vocab, cache_mod = _modules(pkg)
        self.cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
        self.cache.run()
        self.k = 0

    def ts(self):
        self.k += 1
        return TS0 + self.k * 1e-6

    def queue(self, name, weight=1):
        q = self.objects.Queue(name=name, weight=weight)
        q.creation_timestamp = self.ts()
        self.cache.add_queue(q)

    def node(self, name, alloc):
        self.cache.add_node(self.objects.NodeSpec(name=name, allocatable=dict(alloc, pods=110)))

    def group(self, name, queue="default", min_member=1, phase="Inqueue"):
        pg = self.objects.PodGroup(name=name, namespace="default", queue=queue,
                                   min_member=min_member)
        pg.status.phase = phase
        pg.creation_timestamp = self.ts()
        self.cache.add_pod_group(pg)

    def pod(self, name, group, req, node="", phase="Pending", priority=0):
        pod = self.objects.PodSpec(
            name=name, namespace="default", containers=[dict(req)], node_name=node,
            phase=phase, priority=priority,
            annotations={self.objects.GROUP_NAME_ANNOTATION: group})
        pod.creation_timestamp = self.ts()
        self.cache.add_pod(pod)


def releasing_twin(pkg, seed):
    """``tests/test_fused.py::build_releasing_cluster``: queues qa, qb of
    weights 1, 2 on 4 nodes of 4 cpu; one running gang of four full-node
    pods, evicted in the cache (releasing); six pending gangs in both
    queues, drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    tw = _Twin(pkg)
    tw.queue("qa", 1)
    tw.queue("qb", 2)
    for i in range(4):
        tw.node(f"n{i:03d}", {"cpu": 4000.0, "memory": 8 * 1024**3})
    tw.group("old", queue="qa", min_member=4, phase="Running")
    for i in range(4):
        tw.pod(f"old-{i}", "old", {"cpu": 4000.0, "memory": 8 * 1024**3}, node=f"n{i:03d}",
               phase="Running")
    for task in list(tw.cache.jobs["default/old"].tasks.values()):
        tw.cache.evict(task, "make room")
    for j in range(6):
        group = f"new{j}"
        size = int(rng.integers(1, 4))
        tw.group(group, queue=("qa", "qb")[j % 2], min_member=int(rng.integers(1, size + 1)))
        for t in range(size):
            tw.pod(f"{group}-{t}", group,
                   {"cpu": float(rng.choice([1000, 2000])),
                    "memory": float(rng.choice([2, 4])) * 1024**3},
                   priority=int(rng.integers(0, 3)))
    return tw.cache


def aftermath_twin(pkg, scale):
    """``harness.make_reclaim_aftermath_cluster(scale)`` in either package:
    the port's harness, and the same recipe with the JAX package's objects
    (``scripts/scenario_ladder.py`` scenario 4's build at fixed timestamps,
    then ``cache.evict`` on every pod of every odd-numbered ``fat`` gang)."""
    if pkg == "scheduler_tpu_torch":
        from scheduler_tpu_torch.harness import make_reclaim_aftermath_cluster

        return make_reclaim_aftermath_cluster(scale).cache
    objects, vocab, cache_mod = _modules(pkg)
    gang, n_nodes, n_run, n_pend = 50, int(1000 * scale), int(25_000 * scale), int(50_000 * scale)
    slots = n_run // n_nodes + 1
    cache = cache_mod.SchedulerCache(vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    for k, name in enumerate(("fat", "thin")):
        queue = objects.Queue(name=name, weight=1)
        queue.creation_timestamp = TS0 + k * 1e-6
        cache.add_queue(queue)
    for i in range(n_nodes):
        cache.add_node(objects.NodeSpec(name=f"n{i:05d}", allocatable={
            "cpu": 2000.0 * slots, "memory": 4 * GIB * slots, "pods": 110}))

    def add_gang(name, queue, ts, running, first):
        pg = objects.PodGroup(name=name, namespace="d", queue=queue, min_member=1)
        pg.status.phase = "Running" if running else "Inqueue"
        pg.creation_timestamp = ts
        cache.add_pod_group(pg)
        for t in range(gang):
            pod = objects.PodSpec(
                name=f"{name}-{t}", namespace="d",
                containers=[{"cpu": 2000.0, "memory": 4 * GIB}],
                annotations={objects.GROUP_NAME_ANNOTATION: name},
                node_name=f"n{(first + t) % n_nodes:05d}" if running else "",
                phase="Running" if running else "Pending")
            pod.creation_timestamp = ts + t * 1e-6
            cache.add_pod(pod)

    n_fat = n_run // gang
    for j in range(n_fat):
        add_gang(f"fat{j}", "fat", TS0 + 1.0 + j, True, j * gang)
    for j in range(n_pend // gang):
        add_gang(f"thin{j}", "thin", TS0 + 1.0 + n_fat + j, False, 0)
    for j in range(1, n_fat, 2):
        for task in list(cache.jobs[f"d/fat{j}"].tasks.values()):
            cache.evict(task, "reclaim")
    return cache


def open_in(pkg, cache, conf_text):
    conf = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    return framework.open_session(cache, conf.parse_scheduler_conf(conf_text).tiers, **kw)


def session_outcome(pkg, cache, ssn):
    """Name-keyed statuses and nodes, FitErrors, the node ledgers and
    proportion's queue attributes of the open session after its allocate
    action; then close it and read the binds."""
    statuses = {t.name: (t.status.name, t.node_name)
                for job in ssn.jobs.values() for t in job.tasks.values()}
    fit_errors = {t.name: job.nodes_fit_errors[t.uid].error()
                  for job in ssn.jobs.values() for t in job.tasks.values()
                  if t.uid in job.nodes_fit_errors}
    ledgers = {name: tuple(tuple(getattr(n, v).array.tolist())
                           for v in ("idle", "releasing", "used"))
               for name, n in ssn.nodes.items()}
    queues = None
    if "proportion" in ssn.plugins:
        from tests.test_torch_proportion import queue_state

        queues = queue_state(ssn)
    importlib.import_module(f"{pkg}.framework").close_session(ssn)
    return statuses, fit_errors, ledgers, queues, dict(cache.binder.binds)


def run_allocate(pkg, cache, conf_text, host_loop=False):
    ssn = open_in(pkg, cache, conf_text)
    if host_loop:
        from scheduler_tpu_torch.actions import allocate

        allocate.AllocateAction()._heap_loop(ssn, allocate.collect_candidates(ssn))
    else:
        importlib.import_module(f"{pkg}.framework").get_action("allocate").execute(ssn)
    return session_outcome(pkg, cache, ssn)


# -- the plain version against the JAX kernel ---------------------------------------

# chip_smoke.MEGA_SYNTHETIC_REL's cases at CPU size, with exact score terms.
SYNTHETIC_REL_CPU = {
    "cursor-all-terms-pods": dict(seed=41, nb=256, r_dim=8, n_jobs=40, n_nodes=200,
                                  releasing=True, weights=(1.0, 1.0, 1.0), score_bound=True,
                                  enforce_pod_count=True, cohort=4),
    "static": dict(seed=42, nb=256, r_dim=3, n_jobs=40, n_nodes=200, releasing=True,
                   use_static=True, weights=(0.0, 1.0, 1.0), score_bound=True),
    "multi-queue-starved": dict(seed=43, nb=256, r_dim=2, n_jobs=40, n_nodes=200,
                                releasing=True, queues=3, starved=True),
    "multi-queue-static-pods": dict(seed=44, nb=256, r_dim=2, n_jobs=40, n_nodes=200,
                                    releasing=True, queues=2, use_static=True,
                                    enforce_pod_count=True),
    "tie-releasing-first": dict(seed=45, nb=256, r_dim=2, n_jobs=20, alike=True,
                                gated=(200, 40), rel_only=(40,), releasing=True,
                                weights=(0.0, 0.0, 0.0)),
    "tie-idle-first": dict(seed=45, nb=256, r_dim=2, n_jobs=20, alike=True, gated=(200, 40),
                           rel_only=(200,), releasing=True, weights=(0.0, 0.0, 0.0)),
    "best-releasing-only": dict(seed=46, nb=256, r_dim=3, n_jobs=40, n_nodes=200,
                                rel_only=(7, 150), releasing=True),
    "pods-gate": dict(seed=64, nb=256, r_dim=2, n_jobs=100, n_nodes=8, releasing=True,
                      enforce_pod_count=True, weights=(0.0, 1.0, 0.0), score_bound=True),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC_REL_CPU))
def test_reference_matches_jax_in_releasing_mode(case):
    spec = SYNTHETIC_REL_CPU[case]
    ops, kw = smoke.mega_operands(exact=True, **spec)
    assert kw["has_releasing"] and np.any(ops["rel0"])
    codes_j, stats_j = jax_mega(*(ops[name] for name in mk.OPERAND_NAMES), interpret=True, **kw)
    args, torch_kw = mega_operands_from_numpy(ops, kw, "cpu")
    codes_t, stats_t = mk.mega_allocate(*args, n_queues=spec.get("queues"), **torch_kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(stats_t.numpy(), np.asarray(stats_j))
    codes = codes_t.numpy()
    piped = codes[codes <= mk.PIPE_BASE]
    assert piped.size > 0, "the case must pipeline"
    assert stats_t[mk.STATS.COHORT_STEPS] == 0, "releasing mode runs one chunk a step"
    if spec.get("queues"):
        # One queue refresh a placing step: each pipelined copy is a step of
        # its own, an allocation may place a batch.
        refreshes = int(stats_t[mk.STATS.QDELTA_UPDATES])
        assert piped.size < refreshes <= int((codes >= 0).sum()) + piped.size
    if case.startswith("tie-"):
        # Equal scores: the lowest index wins, and its idle fit decides.
        first = min(spec["gated"])
        assert codes[0] == (mk.PIPE_BASE - first if first in spec["rel_only"] else first)
    if case == "best-releasing-only":
        assert set(mk.PIPE_BASE - piped[:4]) <= set(spec["rel_only"])
    if case == "pods-gate":
        node = np.where(codes >= 0, codes, mk.PIPE_BASE - codes)[codes != mk.UNPLACED]
        node = node[(node >= 0) & (node < spec["n_nodes"])]
        n = spec["n_nodes"]
        count = np.bincount(node, minlength=n)[:n] + ops["ns0"][8, :n]
        assert (count <= ops["plim"][0, :n]).all()
        assert (count == ops["plim"][0, :n]).any(), "a node must reach its pod limit"


# -- the engine on the JAX tests' releasing sessions -------------------------------------

def _mid_evict_engines():
    """Both packages' engines on the mid-evict session
    (``chip_smoke.mid_evict_cluster``: the pods on n0..n2 evicted, their
    capacity releasing)."""
    engines = []
    for pkg in PKGS:
        ssn = open_in(pkg, smoke.mid_evict_cluster(pkg), BENCH_CONF)
        if pkg == "scheduler_tpu":
            engines.append(JaxFused(ssn, jax_candidates(ssn)))
        else:
            engines.append(TorchFused(ssn, torch_candidates(ssn), device="cpu"))
    return engines


def test_engine_engages_releasing_mode_as_jax():
    """The twin of ``test_mega_kernel_engages_with_releasing_and_matches_xla``:
    both engines take the mega kernel with releasing capacity, stage the same
    26 operands and static arguments, and place alike, with pipelined
    placements."""
    jax_engine, port = _mid_evict_engines()
    assert jax_engine.has_releasing and jax_engine.use_mega
    assert port.has_releasing and port.use_mega and port.engine == "mega"
    assert port._mega_kw["has_releasing"] and port.cohort_effective == 1
    for name, mine, theirs in zip(mk.OPERAND_NAMES, port._mega_args, jax_engine._mega_args):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=name)
    for key, value in port._mega_kw.items():
        if key != "cohort":
            assert jax_engine._mega_kw[key] == value, key
    assert np.any(port._mega_args[mk.OPERAND_NAMES.index("rel0")].numpy())
    codes_j = np.asarray(jax_engine._execute())[: jax_engine.flat_count]
    codes = port.readback()[: port.flat_count]
    np.testing.assert_array_equal(codes, codes_j)
    assert int((codes <= mk.PIPE_BASE).sum()) > 0, "expected pipelined placements"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipelined_sessions_match_jax_and_the_host_loop(seed):
    """The twin of ``tests/test_fused.py::test_proportion_pipelined_parity``:
    one allocate action in each package, and the port's host loop: binds,
    every task's status and node (PIPELINED among them), FitErrors, node
    ledgers and proportion's queue attributes."""
    jax_out = run_allocate("scheduler_tpu", releasing_twin("scheduler_tpu", seed),
                           PROPORTION_CONF)
    port_out = run_allocate("scheduler_tpu_torch", releasing_twin("scheduler_tpu_torch", seed),
                            PROPORTION_CONF)
    host_out = run_allocate("scheduler_tpu_torch", releasing_twin("scheduler_tpu_torch", seed),
                            PROPORTION_CONF, host_loop=True)
    assert port_out == jax_out
    assert port_out[0] == host_out[0] and port_out[4] == host_out[4]
    assert any(status == "PIPELINED" for status, _ in port_out[0].values())


# -- the slice: config 4 after its reclaim ---------------------------------------------

RECLAIM_SCALE = 0.02


def test_aftermath_allocate_matches_jax():
    """One allocate action on the config 4 aftermath at scale 0.02 (20
    nodes, 500 running pods of which 250 releasing, 1,000 pending) in each
    package: 20 tasks allocated on idle and 240 pipelined, ``thin`` up to
    its deserved share; statuses, FitErrors, node ledgers, queue
    attributes and binds equal."""
    outs = [run_allocate(pkg, aftermath_twin(pkg, RECLAIM_SCALE), smoke.RECLAIM_CONF)
            for pkg in PKGS]
    assert outs[1] == outs[0]
    statuses = [status for status, _ in outs[1][0].values()]
    assert statuses.count("PIPELINED") == 240
    assert statuses.count("RELEASING") == 250
    assert len(outs[1][4]) == 20


def test_aftermath_run_once_matches_jax(tmp_path, monkeypatch):
    """``Scheduler.run_once`` on the config 4 aftermath in each package:
    binds, the cache's task statuses and node ledgers after the cycle, and
    the engine's ``run_stats()`` key for key, the signature-class evidence
    (``sig``) included (but proportion's wall time)."""
    conf = tmp_path / "conf.yaml"
    conf.write_text(smoke.RECLAIM_CONF)
    stats, result = {}, {}
    for pkg in PKGS:
        fused = importlib.import_module(f"{pkg}.ops.fused").FusedAllocator
        run_stats = fused.run_stats

        def spy(self, run_stats=run_stats, pkg=pkg):
            out = run_stats(self)
            stats[pkg] = copy.deepcopy(out)
            return out

        monkeypatch.setattr(fused, "run_stats", spy)
        scheduler = importlib.import_module(f"{pkg}.scheduler").Scheduler
        kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
        cache = aftermath_twin(pkg, RECLAIM_SCALE)
        scheduler(cache, scheduler_conf=str(conf), **kw).run_once()
        result[pkg] = (
            dict(cache.binder.binds),
            {t.name: t.status.name for job in cache.jobs.values() for t in job.tasks.values()},
            {name: tuple(tuple(getattr(n, v).array.tolist()) for v in ("idle", "releasing", "used"))
             for name, n in cache.nodes.items()},
        )
    assert result["scheduler_tpu_torch"] == result["scheduler_tpu"]
    assert len(result["scheduler_tpu_torch"][0]) == 20
    jax_stats, port_stats = stats["scheduler_tpu"], stats["scheduler_tpu_torch"]
    assert port_stats["sig"]["engaged"]
    for block in (jax_stats, port_stats):
        block["qfair"].pop("solve_ms")
    assert port_stats == jax_stats
    assert port_stats["engine"] == "mega" and port_stats["placed"] == 260
    assert port_stats["qfair"]["reason"] == "releasing capacity (pipeline arm)"


# -- the launch plan and the refusals ----------------------------------------------------

@pytest.mark.parametrize("r_dim", range(1, 9))
def test_mega_plan_with_releasing_rows(r_dim):
    """With releasing capacity the node slice holds r_dim more float rows a
    node.  Over the gate's node buckets and job lanes the plan still fits a
    CTA's shared memory, every region on chip exactly where it still fits,
    disjoint and inside the allocation, in the plan's order."""
    budget = mk.SMEM_LIMIT - mk._STATIC_SMEM
    for nb in (128, 1024, 10_112, 16_384, 32_768):
        for j_pad in (256, 1152, 8320, 65_536):
            for n_queues in (0, 3):
                plan = mk.mega_plan(nb, r_dim, j_pad, 128, 8, False, n_queues, True)
                shape = (nb, r_dim, j_pad, n_queues)
                assert plan.ctas in (8, 16) and plan.slice * plan.ctas >= nb, shape
                assert plan.smem_bytes + mk._STATIC_SMEM <= mk.SMEM_LIMIT, shape
                node = mk.node_slice_bytes(plan.slice, r_dim, True)
                assert node == -(-((2 * r_dim + 4) * plan.slice * 4 + plan.slice) // 16) * 16
                used = node + mk.queue_ledger_bytes(n_queues, r_dim)
                if n_queues:
                    assert plan.off_queue == node
                for off, size in ((plan.off_js, mk.job_ledger_bytes(j_pad, r_dim)),
                                  (plan.off_sig, 2 * r_dim * 128 * 4),
                                  (plan.off_job, mk.job_operand_lanes(n_queues) * j_pad * 4)):
                    fits = used + size <= budget
                    assert (off is not None) == fits, shape
                    if fits:
                        assert off == used and off % 16 == 0
                        used = -(-(used + size) // 16) * 16
                assert plan.smem_bytes == used, shape


def test_mega_plan_takes_16_ctas_for_the_releasing_slice():
    """At nb 32,768 and r_dim 8 the 8-CTA slice grows from 200,704 to
    331,776 bytes with the releasing rows and no longer fits a CTA: the
    releasing plan takes 16 CTAs, the plan without stays at 8 (with a job
    ledger small enough to sit beside its slice).  At config 4's nb 1,024
    nothing changes."""
    budget = mk.SMEM_LIMIT - mk._STATIC_SMEM
    assert mk.node_slice_bytes(4096, 8) == 200_704
    assert mk.node_slice_bytes(4096, 8, True) == 331_776 > budget
    assert mk.mega_plan(32_768, 8, 256, 128, 8, False).ctas == 8
    rel = mk.mega_plan(32_768, 8, 256, 128, 8, False, 0, True)
    assert rel.ctas == 16 and rel.slice == 2048 and not rel.job_ledger_in_global
    assert rel.smem_bytes + mk._STATIC_SMEM <= mk.SMEM_LIMIT
    aftermath = dict(nb=1024, r_dim=2, j_pad=1152, s_pad=128, static_rows=8, use_static=False,
                     n_queues=2)
    assert mk.mega_plan(**aftermath, has_releasing=True).ctas == mk.mega_plan(**aftermath).ctas
    ops, kw = smoke.mega_operands(**smoke.MEGA_SYNTHETIC_REL["rel-cursor-nb32768-r8"])
    args, kw = mega_operands_from_numpy(ops, kw, "cpu")
    assert mk.plan_for(args, kw).ctas == 16


def test_releasing_session_past_the_mega_gate_raises():
    """A releasing session that the mega gate closes (here: more than 4,096
    request signatures) takes the loop's releasing arm.  The port took to
    raising here before it had that arm; now its engine runs the loop's XLA
    step arm with the joint idle / releasing fit, and one allocate action
    gives the JAX package's statuses (PIPELINED among them), FitErrors,
    node ledgers and binds."""
    def build(pkg):
        objects = importlib.import_module(f"{pkg}.apis.objects")
        cache = smoke.template_cluster(16, 4200, 1, pkg)
        pg = objects.PodGroup(name="old", namespace="default", queue="default", min_member=1)
        pg.status.phase = "Running"
        cache.add_pod_group(pg)
        node = sorted(cache.nodes)[0]
        cache.add_pod(objects.PodSpec(name="old-0", namespace="default",
                                      containers=[{"cpu": 1000.0, "memory": GIB}],
                                      annotations={objects.GROUP_NAME_ANNOTATION: "old"},
                                      node_name=node, phase="Running"))
        for task in list(cache.jobs["default/old"].tasks.values()):
            cache.evict(task, "reclaim")
        return cache

    ssn = open_in("scheduler_tpu_torch", build("scheduler_tpu_torch"), BENCH_CONF)
    engine = TorchFused(ssn, torch_candidates(ssn), device="cpu")
    assert engine.engine == "xla" and engine.has_releasing
    outs = [run_allocate(pkg, build(pkg), BENCH_CONF) for pkg in PKGS]
    assert outs[1] == outs[0]
    assert any(status == "PIPELINED" for status, _ in outs[1][0].values())


def test_the_mesh_still_raises_in_releasing_mode():
    """Releasing mode runs in mesh mode (one launch, operands whole on the
    mesh's first device) with the codes of the launch without a mesh; a
    mesh that is not a NodeMesh still raises."""
    from scheduler_tpu_torch.ops.mesh import NodeMesh

    ops, kw = smoke.mega_operands(**SYNTHETIC_REL_CPU["static"])
    args, kw = mega_operands_from_numpy(ops, kw, "cpu")
    want = mk.mega_allocate(*args, **kw)
    got = mk.mega_allocate(*args, **dict(kw, mesh=NodeMesh(["cpu"] * 2, {"replica": 1,
                                                                          "nodes": 2})))
    assert all(np.array_equal(g.numpy(), w.numpy()) for g, w in zip(got, want))
    with pytest.raises(TypeError, match="NodeMesh"):
        mk.mega_allocate(*args, **dict(kw, mesh=object()))
