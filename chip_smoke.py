#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scheduler_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

What it does, one JSON line per phase:

1. device: the card, the CUDA version, and the build of every kernel of the
   port from ``scheduler_tpu_torch/csrc`` (seconds, registers per thread).
2. main_path: one cold allocate cycle of the flagship configuration
   (BASELINE config 3: priority, gang, drf, binpack; 10,000 nodes x 100,000
   pods in gangs of 100) through ``Scheduler.run_once`` on the card, on a
   freshly built cluster, with every kernel's launch count set to 0 just
   before and read just after.  It prints the phase seconds and the
   kernel's time from CUDA events, and checks that nothing was
   overcommitted and that every gang is bound whole or not at all.
3. kernel_vs_plain: each kernel's wrapper against its plain PyTorch version
   on the same CUDA tensors, bitwise (codes and stats): BASELINE config 1, a
   1,000-node x 10,000-pod flagship session, a kernel-level case with
   non-binpack weights and the pod-count gate, a 6,000-job case whose job
   ledger lives in global scratch, and the main path's operands at full
   size from a second cluster built the same way (where the kernel and the
   plain version are timed).
4. e2e_small: the fused route on the card against the host loop on small
   clusters, bind for bind.

Then the ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and as the last line ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero; with no CUDA device, or without the port beside
this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory rate
# and float32 rate outside the tensor cores.  They set each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

FLAGSHIP_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: binpack
"""

CONFIG1_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# -- clusters -------------------------------------------------------------------

def config1_cluster():
    """BASELINE config 1 (example/job.yaml): a 3-task gang on 3 nodes."""
    from scheduler_tpu_torch.api.vocab import ResourceVocabulary
    from scheduler_tpu_torch.apis.objects import (
        GROUP_NAME_ANNOTATION, NodeSpec, PodGroup, PodSpec, Queue,
    )
    from scheduler_tpu_torch.cache.cache import SchedulerCache

    cache = SchedulerCache(vocab=ResourceVocabulary(), async_io=False)
    cache.run()
    cache.add_queue(Queue(name="default", weight=1))
    for i in range(3):
        cache.add_node(NodeSpec(name=f"n{i}", allocatable={
            "cpu": 2000.0, "memory": 4 * 2.0**30, "pods": 110}))
    pg = PodGroup(name="qj", namespace="default", queue="default", min_member=3)
    pg.status.phase = "Inqueue"
    pg.creation_timestamp = 1_700_000_000.0
    cache.add_pod_group(pg)
    for t in range(3):
        pod = PodSpec(name=f"qj-{t}", namespace="default",
                      containers=[{"cpu": 1000.0, "memory": 2.0**30}],
                      annotations={GROUP_NAME_ANNOTATION: "qj"})
        pod.creation_timestamp = 1_700_000_000.0 + (t + 1) * 1e-6
        cache.add_pod(pod)
    return cache


def uniform_gang_request(j: int, t: int):
    """Identical requests within each gang (so runs batch and cohorts spill),
    three shapes across gangs."""
    del t
    return {"cpu": [250.0, 500.0, 1000.0][j % 3],
            "memory": [256.0, 512.0, 1024.0][j % 3] * 2.0**20}


def many_jobs_cluster():
    """6,000 single-task jobs on 64 nodes: the job ledger outgrows shared
    memory (j_pad 6144) and lives in global scratch; the cluster is too
    small for them all, so some jobs fail."""
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    return make_synthetic_cluster(64, 6000, tasks_per_job=1).cache


def engine_for(cache, conf_text, device):
    """Open a session on ``cache`` and build the fused engine over its
    allocate candidates (the session is left open: nothing is committed)."""
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import open_session
    from scheduler_tpu_torch.ops.fused import FusedAllocator

    ssn = open_session(cache, parse_scheduler_conf(conf_text).tiers, device=device)
    engine = FusedAllocator(ssn, collect_candidates(ssn), device=device)
    if not engine.use_mega:
        raise RuntimeError("the fused engine did not stage the mega kernel")
    return ssn, engine


# -- kernel against its plain version ---------------------------------------------

def cursor_mode_inputs(args):
    """The operands cursor mode reads (the others are dummies)."""
    from scheduler_tpu_torch.ops.megakernel import OPERAND_NAMES

    unread = {"rel0", "msig", "smask", "sscore", "jqueue", "jq_des",
              "jq_alloc0", "qf_share", "qf_over"}
    return [a for name, a in zip(OPERAND_NAMES, args) if name not in unread]


def node_step_ops(kw) -> int:
    """Float32 operations per node per placement step of the kernel's node
    loop, counted from its source: the epsilon fit (6 a dimension), the
    pod-count gate, the score terms and the masked argmax."""
    ops = 6 * kw["r_dim"] + 1 + 3
    if kw["enforce_pod_count"]:
        ops += 1
    lr_w, bal_w, bp_w = kw["weights"]
    if lr_w or bal_w or bp_w:
        ops += 6  # safe divisors and the post-placement request per dimension
    ops += 13 * bool(lr_w) + 12 * bool(bal_w) + 11 * bool(bp_w)
    return ops


def bound_ms(args, kw, codes, stats, n_real: int):
    """The least time the card could take for this run: each input read
    once and each output written once at the memory rate, against the node
    loop's float32 operations (steps x real nodes x ops) at the peak rate."""
    from scheduler_tpu_torch.ops.layout import STATS

    nbytes = sum(a.numel() * a.element_size() for a in cursor_mode_inputs(args))
    nbytes += codes.numel() * codes.element_size() + stats.numel() * stats.element_size()
    ops = int(stats[STATS.STEPS]) * n_real * node_step_ops(kw)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def compare(case, args, kw, n_real, timed=False, repeats=3):
    """Kernel and plain version on the same CUDA operands: codes and stats
    must be bitwise equal.  With ``timed`` both are timed with CUDA events."""
    import torch

    from scheduler_tpu_torch.ops import megakernel as mk

    codes_k, stats_k = mk.mega_allocate(*args, **kw)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    codes_r, stats_r = mk.mega_allocate_reference(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    equal = bool(torch.equal(codes_k, codes_r) and torch.equal(stats_k, stats_r))
    max_abs_err = int((codes_k.long() - codes_r.long()).abs().max()) if codes_k.numel() else 0
    rec = {
        "phase": "kernel_vs_plain", "case": case, "equal": equal,
        "max_abs_err": max_abs_err,
        "placed": int((codes_k >= 0).sum()),
        "stats": stats_k.tolist(), "plain_stats": stats_r.tolist(),
        "nb": int(args[0].shape[1]), "t_pad": int(codes_k.numel()),
        "cohort": kw["cohort"], "score_bound": kw["score_bound"],
        "enforce_pod_count": kw["enforce_pod_count"],
    }
    if timed:
        start.record()
        for _ in range(repeats):
            mk.mega_allocate(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        rec["ms"] = start.elapsed_time(stop) / repeats
        rec["plain_ms"] = plain_ms
        rec["bound_ms"], rec["bound_by"] = bound_ms(args, kw, codes_k, stats_k, n_real)
    emit(rec)
    if not equal:
        raise SystemExit(f"kernel and plain version disagree: {case}")
    return rec


# -- checks of what the main path bound --------------------------------------------

def check_binds(cache, n_nodes, n_pods, tasks_per_job):
    """No node overcommitted (by the pods' own requests and by the cache's
    idle ledger) and every gang bound whole or not at all."""
    from scheduler_tpu_torch.harness.synthetic import GIB, mixed_request

    binds = dict(cache.binder.binds)
    used = {}
    per_gang = {}
    for key, host in binds.items():
        name = key.split("/", 1)[1]
        group, t = name.rsplit("-", 1)
        j = int(group.split("-")[1])
        req = mixed_request(j * tasks_per_job + int(t), False)
        cpu, mem = used.get(host, (0.0, 0.0))
        used[host] = (cpu + req["cpu"], mem + req["memory"])
        per_gang[j] = per_gang.get(j, 0) + 1
    over = [h for h, (c, m) in used.items() if c > 64_000.0 or m > 256.0 * GIB]
    if over:
        raise SystemExit(f"overcommitted nodes: {over[:5]}")
    # Every pod of a fixture gang counts toward minMember: gang == size.
    for j, bound in per_gang.items():
        size = min(tasks_per_job, n_pods - j * tasks_per_job)
        if bound < size:
            raise SystemExit(f"gang job-{j:05d} bound {bound} of minMember {size}")
    mins = cache.vocab.min_thresholds()
    idle_min = min(float((n.idle.array[:2] + mins[:2]).min()) for n in cache.nodes.values())
    if idle_min < 0.0:
        raise SystemExit("a node's idle ledger is below -epsilon after commit")
    return len(binds), len(per_gang)


# -- phases -------------------------------------------------------------------------

def phase_device():
    import torch

    from scheduler_tpu_torch.ops import megakernel as mk

    info = mk.build(verbose=True)
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    emit({"phase": "device", "gpu": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": info["seconds"],
          "ptxas": regs})


def phase_kernel_cases(device):
    from scheduler_tpu_torch.harness import make_synthetic_cluster
    from scheduler_tpu_torch.ops import megakernel as mk

    _, eng = engine_for(config1_cluster(), CONFIG1_CONF, device)
    compare("config1", eng._mega_args, eng._mega_kw, eng.st.nodes.count)

    cl = make_synthetic_cluster(1000, 10_000, tasks_per_job=100)
    _, eng = engine_for(cl.cache, FLAGSHIP_CONF, device)
    compare("flagship_1k_x_10k", eng._mega_args, eng._mega_kw, eng.st.nodes.count)

    # Kernel level: identical-request gangs on a tight cluster, with the
    # least-requested and balanced weights (so the top-2 score bound cuts
    # batches) and the pod-count gate on, and four cohort chunks.
    cl = make_synthetic_cluster(100, 10_000, tasks_per_job=100,
                                request_fn=uniform_gang_request)
    _, eng = engine_for(cl.cache, FLAGSHIP_CONF, device)
    kw = dict(eng._mega_kw, weights=(1.0, 1.0, 1.0), score_bound=True,
              enforce_pod_count=True, cohort=4)
    if not kw["batch_runs"]:
        raise SystemExit("the kernel-level case must batch runs")
    compare("score_bound_pod_count", eng._mega_args, kw, eng.st.nodes.count)

    _, eng = engine_for(many_jobs_cluster(), FLAGSHIP_CONF, device)
    j_pad = dict(zip(mk.OPERAND_NAMES, eng._mega_args))["job_off"].shape[1]
    if not mk.job_ledger_in_global(j_pad, eng._mega_kw["r_dim"]):
        raise SystemExit("the many-jobs case must put the job ledger in global scratch")
    compare("global_job_ledger", eng._mega_args, eng._mega_kw, eng.st.nodes.count)


def phase_full_size(cache, device):
    """The main path's operands (a session opened on a cluster built as the
    main path's was): kernel against plain, timed."""
    t0 = time.perf_counter()
    _, eng = engine_for(cache, FLAGSHIP_CONF, device)
    init_s = time.perf_counter() - t0
    rec = compare("main_path_operands", eng._mega_args, eng._mega_kw,
                  eng.st.nodes.count, timed=True)
    steps = rec["stats"][0]
    nb = rec["nb"]
    r_dim = eng._mega_kw["r_dim"]
    # The floor of a design that re-reads the idle and task-count rows of the
    # node ledger from device memory on every step.
    ledger_floor_ms = 1e3 * steps * (r_dim + 1) * nb * 4 / HBM_BYTES_PER_S
    emit({"phase": "full_size", "engine_init_s": init_s,
          "ledger_reread_floor_ms": ledger_floor_ms})
    return rec


def phase_main_path(cache, conf_path, n_nodes, n_pods, tasks_per_job):
    import torch

    from scheduler_tpu_torch.actions import allocate
    from scheduler_tpu_torch.ops import megakernel as mk
    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils import phases

    sched = Scheduler(cache, scheduler_conf=conf_path)  # device None: the card
    allocate.routes["fused"] = allocate.routes["host"] = 0
    mk.launches = 0
    phases.begin()
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    notes = phases.take_notes()
    spent = phases.end()
    launches = {"mega_allocate": mk.launches}
    routes = dict(allocate.routes)
    binds, gangs = check_binds(cache, n_nodes, n_pods, tasks_per_job)
    evidence = notes.get("cohort") or {}
    emit({"phase": "main_path", "nodes": n_nodes, "pods": n_pods,
          "binds": binds, "gangs_bound": gangs, "cycle_s": cycle_s,
          "phases_s": spent, "kernel_ms": evidence.get("kernel_ms"),
          "steps": evidence.get("steps"), "cohort": evidence,
          "launches": launches, "routes": routes})
    if launches["mega_allocate"] < 1 or evidence.get("kernel_ms") is None:
        raise SystemExit("the main path did not launch mega_allocate")
    if routes["host"] != 0 or routes["fused"] < 1:
        raise SystemExit(f"the main path took the host route: {routes}")
    if binds < 1:
        raise SystemExit("the main path bound nothing")
    return launches


def phase_e2e_small(conf_path):
    """The fused route on the card against the host loop on the CPU, on
    clusters small enough for the host loop: equal binds."""
    from scheduler_tpu_torch.actions.allocate import AllocateAction, collect_candidates
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.harness import make_synthetic_cluster
    from scheduler_tpu_torch.scheduler import Scheduler

    cases = (
        ("config1", lambda: config1_cluster(), CONFIG1_CONF),
        ("flagship_64_x_600", lambda: make_synthetic_cluster(64, 600, tasks_per_job=10).cache,
         FLAGSHIP_CONF),
        ("flagship_8_x_600", lambda: make_synthetic_cluster(8, 600, tasks_per_job=10).cache,
         FLAGSHIP_CONF),
    )
    for name, build, conf_text in cases:
        with open(conf_path, "w") as f:
            f.write(conf_text)
        gpu = build()
        Scheduler(gpu, scheduler_conf=conf_path).run_once()
        host = build()
        ssn = open_session(host, parse_scheduler_conf(conf_text).tiers, device="cpu")
        AllocateAction()._heap_loop(ssn, collect_candidates(ssn))
        close_session(ssn)
        equal = dict(gpu.binder.binds) == dict(host.binder.binds)
        emit({"phase": "e2e_small", "case": name, "binds": len(gpu.binder.binds),
              "equal_to_host_loop": equal})
        if not equal or not gpu.binder.binds:
            raise SystemExit(f"fused route and host loop disagree: {name}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nodes", type=int, default=10_000)
    parser.add_argument("--pods", type=int, default=100_000)
    parser.add_argument("--tasks-per-job", type=int, default=100)
    opts = parser.parse_args()

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import scheduler_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 2
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    conf_path = os.path.join(out_dir, "chip_smoke_conf.yaml")

    phase_device()
    smi = nvidia_smi_line()

    def flagship_cluster():
        t0 = time.perf_counter()
        cl = make_synthetic_cluster(opts.nodes, opts.pods, tasks_per_job=opts.tasks_per_job)
        emit({"phase": "cluster", "nodes": opts.nodes, "pods": opts.pods,
              "build_s": time.perf_counter() - t0})
        return cl.cache

    # The main path first, on a cluster no other session has touched: one
    # cold cycle, as a scheduler's first cycle after start-up.
    with open(conf_path, "w") as f:
        f.write(FLAGSHIP_CONF)
    launches = phase_main_path(flagship_cluster(), conf_path, opts.nodes, opts.pods,
                               opts.tasks_per_job)
    phase_kernel_cases(device)
    # The same operands again, from a second cluster built the same way.
    full = phase_full_size(flagship_cluster(), device)
    phase_e2e_small(conf_path)

    emit({"kernels": [{
        "name": "mega_allocate",
        "route": "cuda",
        "source": "scheduler_tpu_torch/csrc/mega_allocate.cu",
        "replaces": "scheduler_tpu/ops/megakernel.py:181",
        "launches": launches["mega_allocate"],
        "max_abs_err": full["max_abs_err"],
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
