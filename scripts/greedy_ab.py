#!/usr/bin/env python3
"""Time the greedy main paths of an earlier checkout against this one's, on one card.

    python3 scripts/greedy_ab.py --base DIR [--rounds 1] [--paths a,b,l] [--l-repeats 2]
                                 [--out PATH]

runs three arms, each in child processes of its own (a fresh interpreter
that imports its tree's ``scheduler_tpu_torch`` and ``chip_smoke.py``):

* ``base``: the checkout unpacked at ``DIR`` (an earlier commit);
* ``new``: this checkout;
* ``numpy``: this checkout with ``SCHEDULER_TORCH_NATIVE=0`` (the numpy
  halves of the host commit instead of the C++ library).

in the order base, new, numpy, numpy, new, base (``--rounds`` times).  A
child builds its tree's kernels (and the C++ library where it has one and
the flag is on), then runs, as ``chip_smoke.py`` runs them:

* path a: one cold ``Scheduler.run_once`` of config 2 (1,000 nodes x
  5,000 pods) on a fresh cluster;
* path b: one cold cycle of config 3 (10,000 nodes x 100,000 pods in
  gangs of 100);
* path l: config 3's steady hit (``harness.measure.steady_cycle_phases``:
  the engine built through the engine cache, then one timed cycle that
  hits it), ``--l-repeats`` times, each on a fresh cluster.

``--paths`` runs only the paths named.

Each cycle's binds must be those of the other arms (a digest of the bind
map).  Prints one JSON line per cycle and, last, one summary line: per
arm and path the cycle seconds and each phase's seconds, every sample and
the median.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("base", "new", "numpy")


def load_smoke(tree):
    """``tree``'s ``chip_smoke.py`` as a module, its package first on the path."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def sample(path, rec, digest):
    return {"path": path, "cycle_s": rec["cycle_s"], "phases_s": rec["phases_s"],
            "binds_digest": digest}


def child(tree, arm, out, l_repeats, paths):
    """One arm's paths a, b and l in this process; writes the samples to ``out``."""
    import torch

    smoke = load_smoke(tree)
    import scheduler_tpu_torch  # noqa: F401
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.harness import (
        config3_churn,
        make_kubemark_density_cluster,
        make_synthetic_cluster,
    )
    from scheduler_tpu_torch.harness.measure import steady_cycle_phases
    from scheduler_tpu_torch.ops import engine_cache

    assert os.path.dirname(os.path.abspath(scheduler_tpu_torch.__file__)) == \
        os.path.join(os.path.abspath(tree), "scheduler_tpu_torch")
    torch.backends.cuda.matmul.allow_tf32 = False
    from scheduler_tpu_torch import native
    from scheduler_tpu_torch.ops import cuda_build

    cuda_build.load()
    if hasattr(native, "build") and native.enabled():
        native.build()
    conf_path = os.path.join(os.path.dirname(os.path.abspath(out)), f"greedy_ab_{arm}.yaml")
    samples = []

    def emit(s):
        samples.append(s)
        print(json.dumps({"arm": arm, **s}), flush=True)

    if "a" in paths:
        with open(conf_path, "w") as f:
            f.write(smoke.CONFIG2_CONF)
        cache = make_kubemark_density_cluster(1000, 5000).cache
        rec, _ = smoke.run_cycle(cache, conf_path)
        smoke.check_config2_binds(cache)
        emit(sample("a", rec, smoke.binds_digest(cache.binder.binds)))
        del cache
        gc.collect()
    if "b" in paths:
        with open(conf_path, "w") as f:
            f.write(smoke.FLAGSHIP_CONF)
        cache = make_synthetic_cluster(10_000, 100_000, tasks_per_job=100).cache
        rec, _ = smoke.run_cycle(cache, conf_path)
        smoke.check_binds(cache, 10_000, 100_000, 100)
        emit(sample("b", rec, smoke.binds_digest(cache.binder.binds)))
        del cache
        gc.collect()
    conf = parse_scheduler_conf(smoke.FLAGSHIP_CONF)
    for _ in range(l_repeats if "l" in paths else 0):
        engine_cache.clear()
        gc.collect()
        cache = config3_churn(10_000, 100_000, 100)[0]()
        cycle_s, rec = steady_cycle_phases(cache, conf, ("allocate",))
        notes = rec.pop("notes")
        if notes.get("engine_cache") != "hit":
            raise SystemExit(f"{arm}: path l's steady cycle did not hit: {notes}")
        smoke.check_binds(cache, 10_000, 100_000, 100)
        emit(sample("l", {"cycle_s": cycle_s, "phases_s": {k: v for k, v in rec.items()
                                                         if isinstance(v, float)}},
                    smoke.binds_digest(cache.binder.binds)))
        del cache
    with open(out, "w") as f:
        json.dump(samples, f)
    return 0


def summary(runs):
    """Per arm and path: every sample's cycle and phase seconds and the medians."""
    out = {}
    for arm, samples in runs:
        for s in samples:
            d = out.setdefault(arm, {}).setdefault(s["path"], {"cycle_s": [], "phases_s": {}})
            d["cycle_s"].append(s["cycle_s"])
            for k, v in s["phases_s"].items():
                d["phases_s"].setdefault(k, []).append(v)
    for paths in out.values():
        for d in paths.values():
            d["cycle_median_s"] = statistics.median(d["cycle_s"])
            d["phase_median_s"] = {k: statistics.median(v) for k, v in d["phases_s"].items()}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", help="root of the earlier checkout")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--paths", default="a,b,l")
    parser.add_argument("--l-repeats", type=int, default=2)
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "greedy_ab.json"))
    parser.add_argument("--child", nargs=3, metavar=("TREE", "ARM", "OUT"),
                        help=argparse.SUPPRESS)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("greedy_ab: no CUDA device", file=sys.stderr)
        return 2
    if opts.child:
        return child(*opts.child, opts.l_repeats, opts.paths.split(","))
    if not opts.base:
        parser.error("--base is required")
    opts.out = os.path.abspath(opts.out)
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    trees = {"base": os.path.abspath(opts.base), "new": ROOT, "numpy": ROOT}
    order = (list(ARMS) + list(reversed(ARMS))) * opts.rounds
    runs = []
    for i, arm in enumerate(order):
        path = f"{opts.out}.{i}.{arm}.json"
        env = dict(os.environ)
        if arm == "numpy":
            env["SCHEDULER_TORCH_NATIVE"] = "0"
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--l-repeats",
                             str(opts.l_repeats), "--paths", opts.paths,
                             "--child", trees[arm], arm, path],
                            env=env, cwd=trees[arm]).returncode
        if rc != 0:
            raise SystemExit(f"greedy_ab: the {arm} child failed: rc {rc}")
        with open(path) as f:
            runs.append((arm, json.load(f)))
        print(json.dumps({"arm": arm, "turn": i, "wall_s": time.perf_counter() - t0}), flush=True)
    digests = {}
    for arm, samples in runs:
        for s in samples:
            digests.setdefault(s["path"], set()).add(s["binds_digest"])
    same = {p: len(d) == 1 for p, d in digests.items()}
    result = {"order": order, "binds_equal": same, "arms": summary(runs),
              "gpu": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True).stdout.strip()}
    with open(opts.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
