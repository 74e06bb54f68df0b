#!/usr/bin/env python3
"""Where K2's time goes a step: per-phase clocks of ``mega_allocate``.

    python3 scripts/k2_phases.py [--tree DIR] [--label NAME]
                                 [--configs config2,config3,mq_ladder]

imports ``scheduler_tpu_torch`` and ``chip_smoke.py`` from ``DIR`` (the root
of a checkout: this one by default, or an unpacked earlier commit), builds
that tree's ``csrc/mega_allocate.cu`` a second time with
``-DMEGA_PHASE_CLOCKS`` (a separate library; the port's own build is
untouched), runs it on the operands of BASELINE config 2, config 3, the
multi-queue flagship (``config3_multi_queue``: config 3 in queues of
weights 1:2:3) or the qfair ladder flagship (the main paths' sessions, built
as ``chip_smoke.py`` builds them; the ladder flagship in ladder mode and on
the delta chain), and prints one JSON line a configuration: µs a step in
each phase of the loop, from the SM clock of thread 0 of the cluster's
rank 0 (calibrated against the global timer over the whole loop), and the
loop's time.  The phases follow each other on that
thread; a phase that waits for other warps or CTAs (the barriers) counts
their lateness.  Instrumented, the kernel runs a few percent slower than
the port's build.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("head", "node_pass", "warp_reduce_and_cta_barrier", "cta_pairs_and_push",
          "slot_wait", "merge", "batch_grid", "ledger_updates", "closing_barrier",
          "step_tail")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree",
                        default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default=None)
    parser.add_argument("--configs", default="config2,config3,mq_ladder",
                        help="comma-separated subset of config2, config3, config3_multi_queue, "
                             "mq_ladder")
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("k2_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster, make_synthetic_cluster
    from scheduler_tpu_torch.ops import cuda_build
    from scheduler_tpu_torch.ops import megakernel as mk

    device = torch.device("cuda")
    fn = cuda_build.load_variant(["mega_allocate.cu"], ["MEGA_PHASE_CLOCKS"]).mega_allocate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mk._entry = lambda: fn
    mk.phase_clocks = torch.zeros(mk.PHASE_WORDS, dtype=torch.int64, device=device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def ladder():
        from scheduler_tpu_torch.harness import make_mq_ladder_cluster  # trees since the ladder

        return make_mq_ladder_cluster(smoke.LADDER_NODES, smoke.LADDER_PODS, smoke.LADDER_QUEUES,
                                      smoke.LADDER_VOCAB).cache

    configs = {
        "config2": (lambda: make_kubemark_density_cluster(1000, 5000).cache, smoke.CONFIG2_CONF),
        "config3": (lambda: make_synthetic_cluster(10_000, 100_000, tasks_per_job=100).cache,
                    smoke.FLAGSHIP_CONF),
        "config3_multi_queue": (
            lambda: make_synthetic_cluster(10_000, 100_000, tasks_per_job=100,
                                           queues=smoke.MQ_QUEUES,
                                           queue_weights=smoke.MQ_WEIGHTS).cache,
            smoke.MULTIQ_CONF),
        "mq_ladder": (ladder, smoke.MULTIQ_CONF),
    }
    for name in opts.configs.split(","):
        build, conf = configs[name]
        _, eng = smoke.engine_for(build(), conf, device)
        n_queues = len(eng.queue_uids)
        chains = [("", eng._mega_kw)]
        if eng._mega_kw.get("qfair_ladder"):
            chains.append(("_delta", dict(eng._mega_kw, qfair_ladder=False)))
        for suffix, kw in chains:
            for _ in range(2):  # the second run is the one read
                _, stats = mk.mega_allocate(*eng._mega_args, n_queues=n_queues, **kw)
                torch.cuda.synchronize()
            clocks = mk.phase_clocks.tolist()
            steps = int(stats[0])
            ghz = clocks[len(PHASES)] / clocks[len(PHASES) + 1]
            print(json.dumps({
                "tree": opts.label or tree, "config": name + suffix, "gpu": smi, "steps": steps,
                "loop_ms": clocks[len(PHASES) + 1] / 1e6, "sm_ghz": ghz,
                "plan": mk.plan_for(eng._mega_args, kw, n_queues).summary(),
                "us_per_step": {p: clocks[k] / ghz / 1e3 / steps for k, p in enumerate(PHASES)},
            }), flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
