#!/usr/bin/env python3
"""Time K2 (``mega_allocate``) of one checkout of the port on the card.

    python3 scripts/k2_ab.py --tree DIR [--label NAME] [--configs A,B,...]

imports ``scheduler_tpu_torch`` and ``chip_smoke.py`` from ``DIR`` (the
root of a checkout: this one by default, or an unpacked earlier commit),
builds that tree's kernels, and prints one JSON summary line, last:

* one cold cycle through ``Scheduler.run_once`` (cycle seconds, K2's
  events in the cycle, steps) of each of BASELINE config 2 (static-row
  mode), config 3 (cursor mode), the multi-queue flagship (config 3 in
  queues of weights 1:2:3: multi-queue mode) and config 2 under the JAX
  default conf's plugin tiers (multi-queue mode with static rows);
* K2 alone on the operands of those main paths, from second clusters built
  the same way: device time a launch from a profiler trace, CUDA events
  around ``--repeats`` launches, µs a step, and whether codes and stats
  equal the first launch's (the kernel's bits against the plain version
  are ``chip_smoke.py``'s to check);
* on a tree that has the qfair ladder, the ladder flagship (``mq_ladder``:
  ``harness.make_mq_ladder_cluster(10_000, 100_000, 100, 6)``, the
  multi-queue conf): its cold cycle, K2 alone in ladder mode and on the
  delta chain on the same operands (events around one launch, the two
  chains in turns, ``--repeats`` each), and proportion's water-fill at its
  100 queues: ``qfair_solve``'s time against the host water-fill's
  ``solve_ms`` on the same queue attributes (``chip_smoke.py``'s records of
  these comparisons print before the summary line);
* on a tree that has releasing capacity, BASELINE config 4 after its
  reclaim (``config4_reclaim_aftermath``:
  ``harness.make_reclaim_aftermath_cluster()``, ``chip_smoke.RECLAIM_CONF``):
  its cold cycle and K2 alone in multi-queue mode with releasing capacity.

``--configs`` picks a subset (default: every one the tree has).  To compare
two commits on one card, run both trees in one call in the order base,
new, new, base.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time


def ladder_alone(smoke, ssn, eng, device, repeats):
    """K2 on the ladder flagship's operands in ladder mode and on the delta
    chain (``chip_smoke.compare_chains``: equal codes, events around one
    launch in turns, ``repeats`` each), and its session's water-fill
    (``chip_smoke.compare_qfair``: ``qfair_solve`` against its plain
    version, timed) beside the host water-fill's ``solve_ms`` on the same
    queue attributes (``chip_smoke.device_vs_host_solve``)."""
    recs = smoke.compare_chains("mq_ladder", eng._mega_args, eng._mega_kw,
                                eng.st.nodes.count, len(eng.queue_uids), repeats)
    ops = smoke.proportion_solve_operands(ssn, device)
    solve = smoke.compare_qfair("mq_ladder", ops, int(ops[1].shape[0]) + 4, timed=True)
    host = smoke.device_vs_host_solve(ssn)
    rec = {"qfair_ladder": bool(eng._mega_kw["qfair_ladder"]),
           "steps": recs["ladder"]["stats"][0], "placed": recs["ladder"]["placed"],
           "same_codes": recs["ladder"]["equal_codes"],
           "qfair_solve_ms": solve["ms"], "host_solve_ms": host["host_solve_ms"],
           "device_solve_ms": host["device_solve_ms"]}
    for chain, chain_rec in recs.items():
        rec[chain + "_ms"] = chain_rec["event_ms"]
        rec[chain + "_us_per_step"] = chain_rec["us_per_step_events"]
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default=None)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--configs", default=None,
                        help="comma-separated subset of config2, config3, config3_multi_queue, "
                             "config2_default_tiers, mq_ladder, config4_reclaim_aftermath")
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster, make_synthetic_cluster
    from scheduler_tpu_torch.ops import cuda_build
    from scheduler_tpu_torch.ops import megakernel as mk

    device = torch.device("cuda")
    cuda_build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    configs = {
        "config2": (lambda: make_kubemark_density_cluster(1000, 5000).cache, smoke.CONFIG2_CONF),
        "config3": (lambda: make_synthetic_cluster(10_000, 100_000, tasks_per_job=100).cache,
                    smoke.FLAGSHIP_CONF),
        "config3_multi_queue": (
            lambda: make_synthetic_cluster(10_000, 100_000, tasks_per_job=100,
                                           queues=("q0", "q1", "q2"),
                                           queue_weights={"q0": 1, "q1": 2, "q2": 3}).cache,
            smoke.MULTIQ_CONF),
        "config2_default_tiers": (lambda: make_kubemark_density_cluster(1000, 5000).cache,
                                  smoke.DEFAULT_TIERS_CONF),
    }
    has_ladder = hasattr(smoke, "compare_chains")
    if has_ladder:
        from scheduler_tpu_torch.harness import make_mq_ladder_cluster

        configs["mq_ladder"] = (
            lambda: make_mq_ladder_cluster(smoke.LADDER_NODES, smoke.LADDER_PODS,
                                           smoke.LADDER_QUEUES, smoke.LADDER_VOCAB).cache,
            smoke.MULTIQ_CONF)
    if hasattr(smoke, "RECLAIM_CONF"):
        from scheduler_tpu_torch.harness import make_reclaim_aftermath_cluster

        configs["config4_reclaim_aftermath"] = (
            lambda: make_reclaim_aftermath_cluster().cache, smoke.RECLAIM_CONF)
    if opts.configs:
        configs = {k: v for k, v in configs.items() if k in opts.configs.split(",")}
    out = {"tree": opts.label or tree, "gpu": smi, "build_s": cuda_build.build_info["seconds"]}
    with tempfile.TemporaryDirectory() as tmp:
        conf_path = os.path.join(tmp, "conf.yaml")
        for name, (build, conf) in configs.items():
            with open(conf_path, "w") as f:
                f.write(conf)
            rec, launches = smoke.run_cycle(build(), conf_path)
            out[name + "_cycle"] = {"cycle_s": rec["cycle_s"], "kernel_ms": rec["kernel_ms"],
                                    "steps": rec["steps"], "launches": launches["mega_allocate"]}
            gc.collect()
    for name, (build, conf) in configs.items():
        ssn, eng = smoke.engine_for(build(), conf, device)
        if name == "mq_ladder":
            out[name + "_alone"] = ladder_alone(smoke, ssn, eng, device, opts.repeats)
            del ssn, eng
            gc.collect()
            continue
        args, kw = eng._mega_args, dict(eng._mega_kw, n_queues=len(eng.queue_uids))
        codes0, stats0 = mk.mega_allocate(*args, **kw)
        start, stop = smoke.events()
        start.record()
        for _ in range(opts.repeats):
            codes, stats = mk.mega_allocate(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(stop) / opts.repeats
        device_ms, _ = smoke.device_ms_per_call(lambda: mk.mega_allocate(*args, **kw),
                                                opts.repeats, match="mega_allocate_kernel")
        steps = int(stats0[0])
        ms = device_ms if device_ms is not None else event_ms
        out[name + "_alone"] = {
            "device_ms": device_ms, "event_ms": event_ms, "steps": steps,
            "us_per_step": 1e3 * ms / steps,
            "same_result": bool(torch.equal(codes, codes0) and torch.equal(stats, stats0)),
        }
        del eng
        gc.collect()
    out["at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
