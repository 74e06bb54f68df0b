#!/usr/bin/env python3
"""Measure how far ``lp_relax`` lies from its plain version, and how far planted faults lie, on one card.

    python3 scripts/lp_tolerance.py [--out PATH]

For every case of ``chip_smoke.LP_KERNEL_CASES`` and for the tight
operands at path r''s shape (``chip_smoke.LP_TIGHT_SEED``, [8,192 x
1,024], three capacity columns), on the card:

* ``kernel``: the kernel's marginals against the plain version's;
* ``noise``: the plain version on requests scaled by 1 + 1e-7 (about one
  float32 rounding of the load) against the plain version: how far a
  sound change of summation order can move the marginals;
* planted faults, each against the plain version: all-zero marginals, the
  first iteration's marginals (no projection), one iteration fewer, and
  the load 0.1 % high (requests scaled by 1.001).

Each row gives the largest absolute error, the largest relative error
(``|d| / |ref|`` over the cells where ``|ref|`` passes
``chip_smoke.LP_KERNEL_ATOL``) and ``over_tol`` from
``chip_smoke.lp_marginal_errors`` (at most 1 passes).  Prints one JSON
line per case and a summary line last: the largest sound ``over_tol``
(kernel and noise) and, for each planted fault, the smallest
``over_tol`` over the cases that run more than one iteration and whose
projection binds (``converged_at`` not 0; elsewhere a fault may change
nothing).  One iteration fewer is no fault where the solve has settled: it
is reported, not held.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def errors(smoke, x, ref):
    d = (x - ref).abs()
    big = ref.abs() > smoke.LP_KERNEL_ATOL
    rel = float((d[big] / ref.abs()[big]).max()) if bool(big.any()) else 0.0
    return {**smoke.lp_marginal_errors(x, ref), "max_rel_err": rel}


def measure(smoke, name, logits, cap, req_aug, iters, tol=1e-3):
    import torch

    from scheduler_tpu_torch.ops import lp_place

    def plain(req=req_aug, n=iters):
        return lp_place.lp_iterate(logits, cap, req, iters=n, tol=tol, plain=True)

    x, pref, raw = lp_place.lp_iterate(logits, cap, req_aug, iters=iters, tol=tol)
    ref, pref_p, raw_p = plain()
    rows = {"kernel": errors(smoke, x, ref),
            "noise": errors(smoke, plain(req_aug * (1 + 1e-7))[0], ref),
            "zero_marginals": errors(smoke, torch.zeros_like(ref), ref),
            "unprojected": errors(smoke, plain(n=1)[0], ref),
            "load_0.1pct_high": errors(smoke, plain(req_aug * 1.001)[0], ref)}
    if iters > 1:
        rows["one_iteration_fewer"] = errors(smoke, plain(n=iters - 1)[0], ref)
    rec = {"case": name, "rows": logits.shape[0], "n": logits.shape[1], "cols": cap.shape[1],
           "iters": iters, "evidence": raw.tolist(), "pref_equal": bool(torch.equal(pref, pref_p)),
           "evidence_equal": bool(torch.equal(raw, raw_p)), **rows}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "lp_tolerance.json"))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lp_tolerance: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    recs = []
    for name in sorted(smoke.LP_KERNEL_CASES):
        seed, rows, n, r_dim, classes, pod_count, static, tight, iters = \
            smoke.LP_KERNEL_CASES[name]
        ops = smoke.lp_operands(seed, rows, n, r_dim, classes=classes, pod_count=pod_count,
                                static=static, tight=tight)
        recs.append(measure(smoke, name, *smoke.lp_iterate_operands(ops, dev), iters))
    ops = smoke.lp_operands(smoke.LP_TIGHT_SEED, 8192, 1024, 2, tight=True)
    recs.append(measure(smoke, "config2_lp_tight", *smoke.lp_iterate_operands(ops, dev), 200))
    sound = max(max(r["kernel"]["over_tol"], r["noise"]["over_tol"]) for r in recs)
    binding = [r for r in recs if r["iters"] > 1 and r["evidence"][1] != 0]
    planted = {k: min(r[k]["over_tol"] for r in binding)
               for k in ("zero_marginals", "unprojected", "load_0.1pct_high",
                         "one_iteration_fewer")}
    summary = {"rtol": smoke.LP_KERNEL_RTOL, "atol": smoke.LP_KERNEL_ATOL,
               "largest_sound_over_tol": sound,
               "smallest_planted_over_tol_where_the_projection_binds": planted,
               "kernel_over_tol": {r["case"]: r["kernel"]["over_tol"] for r in recs},
               "gpu": torch.cuda.get_device_name(0)}
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump({"cases": recs, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
