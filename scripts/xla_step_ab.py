#!/usr/bin/env python3
"""Time the loop's XLA step arm of an earlier checkout against this one's, on one card.

    python3 scripts/xla_step_ab.py --base DIR [--steps N] [--paths A,B]

loads ``DIR/scheduler_tpu_torch/ops/xla_step.py`` (the root of a checkout:
an unpacked earlier commit, whose arm is PyTorch operations on the card,
about 110 launches and one readback a step; its scoring import resolves
to this checkout's ``ops/scoring.py``) beside this checkout's arm (one
``xla_step`` launch a step, ``csrc/xla_step.cu``), records the first
``--steps`` steps of a main path's loop (``chip_smoke.XlaCapture`` around
the engine's loop on the card), and replays them from the arm's starting
state through the two arms in turns (base, new, new, base):

* ``templates_default_tiers`` (path i): config3_templates' gangs under the
  JAX default conf's tiers, 1,000 nodes x 5,000 gangs of 6 (the top-2
  score bound, static rows, the pod count);
* ``reclaim_aftermath_templates`` (path k): config 4's aftermath with
  5,000 distinct thin requests (the releasing arm).

A step is timed three ways, the same for both arms: CUDA events around
its device work (the base's around its operations, the new one's recorded
by the kernel's entry point around the launch), the host clock around the
step (the round trip: launch or launches, wait, results on the host), and
the profiler's device time (the base's every kernel of a step, the new
one's ``xla_step_kernel``).  The two arms' results must be equal at every
step.  Then this checkout's kernel on the same steps at 128, 256, 512 and
1,024 threads (``xla_step.step_plan`` forced: the smaller ones stride).
Prints one JSON line per turn and one summary JSON line, last.  Needs a
CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PATHS = ("templates_default_tiers", "reclaim_aftermath_templates")


def load_base(tree):
    """The earlier checkout's ``ops/xla_step.py`` as a module of its own."""
    path = os.path.join(tree, "scheduler_tpu_torch", "ops", "xla_step.py")
    spec = importlib.util.spec_from_file_location("base_xla_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(smoke, path, steps):
    """The path's cluster, engine and loop on the card, the arm's first
    ``steps`` steps recorded."""
    import torch

    from scheduler_tpu_torch.harness import make_reclaim_aftermath_cluster
    from scheduler_tpu_torch.ops import fused as fused_mod

    if path == "templates_default_tiers":
        cache, conf = smoke.template_cluster(*smoke.TIERS_TEMPLATES), smoke.DEFAULT_TIERS_CONF
    else:
        cache = make_reclaim_aftermath_cluster(thin_requests=smoke.RECLAIM_THIN_REQUESTS).cache
        conf = smoke.RECLAIM_CONF
    _, eng = smoke.engine_for(cache, conf, torch.device("cuda"), engine="xla")
    with smoke.XlaCapture(steps) as cap:
        fused_mod.fused_allocate(*eng.args, **eng._allocate_kw())
    torch.cuda.synchronize()
    return cap


def turn(smoke, make_arm, steps, label, match):
    """One turn: the steps through a fresh arm (events and host clock), then
    through another under the profiler (device time a step)."""
    arm = make_arm()
    results, host_ms = smoke._replay(arm, steps)
    event_ms = arm.xla_ms / len(steps)
    arm = make_arm()
    feed = iter(steps)
    try:
        device_ms, _ = smoke.device_ms_per_call(lambda: arm.step(*next(feed)), len(steps) - 1,
                                                match=match)
    finally:
        arm.close()
    return results, {"arm": label, "event_ms_per_step": event_ms,
                     "host_ms_per_step": host_ms, "device_ms_per_step": device_ms}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="root of the earlier checkout")
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--paths", default=",".join(PATHS))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("xla_step_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.ops import xla_step

    base = load_base(os.path.abspath(opts.base))
    smi = smoke.nvidia_smi_line()
    summary = {"card": smi, "base": os.path.abspath(opts.base), "steps": opts.steps, "paths": {}}
    for path in opts.paths.split(","):
        t0 = time.perf_counter()
        cap = capture(smoke, path, opts.steps)
        steps = cap.steps
        n, r_dim = cap.args[3].shape
        setup_s = time.perf_counter() - t0
        arms = {"base": (lambda: base.XlaStep(*cap.args, **cap.flags), None),
                "new": (cap.arm, "xla_step_kernel")}
        recs, seen = [], []
        for label in ("base", "new", "new", "base"):
            make_arm, match = arms[label]
            results, rec = turn(smoke, make_arm, steps, label, match)
            rec.update(path=path, n=n, r_dim=r_dim)
            print(json.dumps(rec), flush=True)
            recs.append(rec)
            seen.append(results)
        equal = all(r == seen[0] for r in seen)
        plans = {}
        for threads in (128, 256, 512, 1024):
            plan = xla_step.step_plan(n, threads)
            arm = cap.arm(plan=plan)
            results, host_ms = smoke._replay(arm, steps)
            equal = equal and results == seen[0]
            plans[threads] = {"strides": plan.strides,
                              "event_ms_per_step": arm.xla_ms / len(steps),
                              "host_ms_per_step": host_ms}
        print(json.dumps({"path": path, "plans": plans}), flush=True)

        def mean(label, key):
            vals = [r[key] for r in recs if r["arm"] == label and r[key] is not None]
            return sum(vals) / len(vals) if vals else None

        out = {"n": n, "r_dim": r_dim, "flags": cap.flags, "setup_s": setup_s,
               "equal": equal, "placed": sum(1 for r in seen[0] if r[2] or r[3]),
               "plan": xla_step.step_plan(n).describe(), "plans": plans}
        for key in ("event_ms_per_step", "host_ms_per_step", "device_ms_per_step"):
            out[key] = {"base": mean("base", key), "new": mean("new", key),
                        "turns": [r[key] for r in recs]}
        summary["paths"][path] = out
        del cap
        gc.collect()
        if not equal:
            print(json.dumps(summary), flush=True)
            print(f"xla_step_ab: the arms disagree on {path}", file=sys.stderr)
            return 1
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
