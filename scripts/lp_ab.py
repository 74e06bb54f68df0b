#!/usr/bin/env python3
"""Time ``lp_relax`` of an earlier checkout against this one's, on one card.

    python3 scripts/lp_ab.py --base DIR [--repeats R] [--cases A,B] [--out PATH]

builds ``DIR/scheduler_tpu_torch/csrc/lp_relax.cu`` (the root of a
checkout: an unpacked earlier commit, whose solve is four launches an
iteration, ``lp_row``, ``lp_col``, ``lp_node`` and ``lp_max``, and over
node blocks a row pass a block and ``lp_merge``) into a library of its own
beside this checkout's kernel (one persistent launch a solve on
``lp_place.lp_plan``'s tiling), and runs both on:

* ``r'``: path r''s own operands (config 2 under ``SCHEDULER_TORCH_
  ALLOCATOR=lp``, task by task: [8,192 x 1,024], three capacity columns),
  captured by ``chip_smoke.LpCapture`` around one ``Scheduler.run_once``;
* ``r``: path r's (the flagship on signature classes: [16 x 16,384], two
  columns), captured the same way;
* ``tight``: ``chip_smoke.lp_operands(LP_TIGHT_SEED, ...)`` at r''s shape
  and columns (requests of twice the cluster: the projection binds);
* ``blocks``: r''s logits over four node blocks (``chip_smoke.
  split_lp_call``), each kernel's block entry;
* ``cols16_classes``: tight class-weighted rows at 16 capacity columns
  ([97 x 150], ``tests/test_torch_cuda.py``'s ``LP_COLS16_CLASSES``),
  where float32 moves the plain version past the limit from the float64
  solve: both kernels and the plain version are also held to that solve
  (``lp_iterate_reference`` on float64 operands), the new kernel no
  farther from it than the plain version plus one limit, and within
  ``COLS16_OVER_TOL`` of the plain version.

First the base alone on each case under the profiler: its device time a
solve by kernel name, so the record says which pass loses the time, beside
``torch.matmul(x.T, req_aug)`` at the same shape (one iteration's load
product).  Then the two kernels in turns (base, new, new, base),
``--repeats`` solves a turn, timed by CUDA events around the solves and by
the profiler's device time; each held to the other and to the plain
version (``chip_smoke.lp_marginal_errors``: ``LP_KERNEL_RTOL`` and
``LP_KERNEL_ATOL``), pref and the evidence row equal (a comparison that
does not hold is recorded, listed in the summary's ``failures``, and the
script exits 1).  The profiler
also counts each kernel's launches a solve (the new one must launch once).
Then this
checkout's kernel built with ``-DLP_PHASE_CLOCKS``: CTA 0's SM clocks in
each phase (``lp_place.PHASES``), and its solve under a few forced plans.
Last, ``lp_plan``'s rule (whole rows wherever they fit, else the
tiling of the most CTAs): at [rows x 1,024] and three columns for rows
from 16 to 4,224, the whole-row plan against the tiles plan ``lp_plan``
would pick among tilings, each held to the plain version.  Prints one JSON line a record and a summary line last (also to ``--out``).
Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = ("r'", "r", "tight", "blocks", "cols16_classes")
COLS16_CLASSES = (33, 97, 150, 15)
# The new kernel's limit against its plain version on cols16_classes, in
# units of chip_smoke.lp_marginal_errors' limit (tests/test_torch_cuda.py's
# LP_COLS16_CLASSES_OVER_TOL).
COLS16_OVER_TOL = 2.0
RULE_ROWS = (16, 33, 66, 132, 264, 528, 1056, 2112, 4224)
BASE_CHUNK_ROWS, BASE_NODE_THREADS = 256, 256


def emit(rec, sink):
    line = json.dumps(rec)
    print(line, flush=True)
    sink.append(rec)


def build_base(tree):
    """The earlier checkout's ``lp_relax.cu`` alone, compiled with this
    checkout's flags into ``build/scheduler_tpu_torch/``."""
    from scheduler_tpu_torch.ops import cuda_build

    src = os.path.join(tree, "scheduler_tpu_torch", "csrc", "lp_relax.cu")
    out_dir = cuda_build._build_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"lp-base-{cuda_build._digest([src])}.so")
    if not os.path.exists(path):
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            so = os.path.join(tmp, "base.so")
            res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
                                  so, src], capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"nvcc failed on the base:\n{res.stdout}{res.stderr}")
            os.replace(so, path)
    return ctypes.CDLL(path)


class Base:
    """The four-launch kernel's C entries, called as its own wrapper did."""

    def __init__(self, lib):
        self.one = lib.lp_relax_launch
        self.one.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10)
        self.one.restype = ctypes.c_int
        self.blk = lib.lp_relax_blocks_launch
        self.blk.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                             + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10)
        self.blk.restype = ctypes.c_int

    def solve(self, logits, cap, req_aug, iters, tol):
        import torch

        rows, n = logits.shape
        r = cap.shape[1]
        dev, f32 = logits.device, torch.float32
        chunks = -(-rows // BASE_CHUNK_ROWS)
        x = torch.empty((rows, n), dtype=f32, device=dev)
        pref = torch.empty(rows, dtype=torch.int32, device=dev)
        raw = torch.empty(2, dtype=torch.int32, device=dev)
        log_v, mrow, coef = (torch.empty(k, dtype=f32, device=dev) for k in (n, rows, rows))
        partial = torch.empty((chunks, n, r), dtype=f32, device=dev)
        blockmax = torch.empty(-(-n // BASE_NODE_THREADS), dtype=f32, device=dev)
        gupd = torch.empty(1, dtype=f32, device=dev)
        rc = self.one(logits.data_ptr(), cap.data_ptr(), req_aug.data_ptr(), rows, n, r, iters,
                      float(tol), BASE_CHUNK_ROWS, chunks, log_v.data_ptr(), mrow.data_ptr(),
                      coef.data_ptr(), partial.data_ptr(), blockmax.data_ptr(), gupd.data_ptr(),
                      x.data_ptr(), pref.data_ptr(), raw.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise SystemExit(f"base lp_relax_launch: CUDA error {rc}")
        return [x], pref, raw

    def solve_blocks(self, logits_b, cap_b, req_aug, iters, tol):
        import torch

        d = len(logits_b)
        rows, n = logits_b[0].shape
        r = cap_b[0].shape[1]
        dev, f32 = logits_b[0].device, torch.float32
        chunks = -(-rows // BASE_CHUNK_ROWS)
        x_b = [torch.empty((rows, n), dtype=f32, device=dev) for _ in range(d)]
        log_v = [torch.empty(n, dtype=f32, device=dev) for _ in range(d)]
        partial = [torch.empty((chunks, n, r), dtype=f32, device=dev) for _ in range(d)]
        blockmax = [torch.empty(-(-n // BASE_NODE_THREADS), dtype=f32, device=dev)
                    for _ in range(d)]
        gupd = torch.empty(d, dtype=f32, device=dev)
        pack = torch.empty((d, 4, rows), dtype=f32, device=dev)
        coef = torch.empty((d, rows), dtype=f32, device=dev)
        pref = torch.empty(rows, dtype=torch.int32, device=dev)
        raw = torch.empty(2, dtype=torch.int32, device=dev)

        def ptrs(ts):
            return (ctypes.c_void_p * d)(*[t.data_ptr() for t in ts])

        keep = [ptrs(logits_b), ptrs(cap_b), ptrs(log_v), ptrs(partial), ptrs(blockmax),
                ptrs(x_b)]
        rc = self.blk(d, ctypes.addressof(keep[0]), ctypes.addressof(keep[1]),
                      req_aug.data_ptr(), rows, n, r, iters, float(tol), BASE_CHUNK_ROWS,
                      chunks, ctypes.addressof(keep[2]), ctypes.addressof(keep[3]),
                      ctypes.addressof(keep[4]), gupd.data_ptr(), pack.data_ptr(),
                      coef.data_ptr(), ctypes.addressof(keep[5]), pref.data_ptr(),
                      raw.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise SystemExit(f"base lp_relax_blocks_launch: CUDA error {rc}")
        return x_b, pref, raw


def capture(smoke, opts, path):
    """Path ``path``'s relaxation operands, from one cold LP cycle on a fresh
    cluster built as chip_smoke builds it: (logits, cap, req_aug, iters,
    tol)."""
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster, make_synthetic_cluster

    os.environ["SCHEDULER_TORCH_ALLOCATOR"] = "lp"
    conf_path = os.path.join(opts.work, "lp_ab_conf.yaml")
    if path == "r":
        os.environ.pop("SCHEDULER_TORCH_SIG_COMPRESS", None)
        conf = smoke.FLAGSHIP_CONF
        cache = make_synthetic_cluster(opts.nodes, opts.pods,
                                       tasks_per_job=opts.tasks_per_job).cache
    else:
        os.environ["SCHEDULER_TORCH_SIG_COMPRESS"] = "off"
        conf = smoke.CONFIG2_CONF
        cache = make_kubemark_density_cluster(opts.config2_nodes, opts.config2_pods).cache
    with open(conf_path, "w") as f:
        f.write(conf)
    _, _, cap, _ = smoke.lp_cycle(cache, conf_path, path)
    call = cap.calls[0]
    del cache, cap
    gc.collect()
    os.environ.pop("SCHEDULER_TORCH_ALLOCATOR", None)
    os.environ.pop("SCHEDULER_TORCH_SIG_COMPRESS", None)
    return call


def check(smoke, got, ref, what, failures, limit=1.0):
    """``got`` against ``ref``: the errors, whether pref and the evidence
    row are equal and whether it is held (within ``limit`` of the limit,
    both equal); what is not held is added to ``failures``."""
    import torch

    errs = smoke.lp_marginal_errors(torch.cat(got[0], dim=1), torch.cat(ref[0], dim=1))
    errs["pref_rows_differing"] = int((got[1] != ref[1]).sum())
    errs["evidence"] = [got[2].tolist(), ref[2].tolist()]
    errs["held"] = errs["over_tol"] <= limit and not errs["pref_rows_differing"] \
        and errs["evidence"][0] == errs["evidence"][1]
    if not errs["held"]:
        failures.append(f"{what}: {errs}")
    return errs


def timed(smoke, fn, repeats):
    """(events ms a solve, profiler device ms a solve, device ms by kernel
    name a solve)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, stop = smoke.events()
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / repeats
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = (getattr(evt, "self_device_time_total", 0)
                  or getattr(evt, "self_cuda_time_total", 0))
            by_name[evt.key] = {"ms": 1e-3 * us / repeats, "launches": evt.count / repeats}
    device = sum(v["ms"] for v in by_name.values())
    return ms, (device if device > 0 else None), by_name


def plan_rule(smoke, lp_place, dev, opts, out, failures):
    """``lp_plan``'s rule at [rows x 1,024], three columns, ``RULE_ROWS``:
    the whole-row plan against the tiles plan ``lp_plan`` would pick among
    tilings (``mode="tiles"``), each held to the plain version, events ms a
    solve; which plan the default is."""
    import torch

    sms = lp_place.device_sms(dev)
    rule = []
    for i, rows in enumerate(RULE_ROWS):
        ops = smoke.lp_operands(40 + i, rows, 1024, 2)
        logits, cap, req_aug = smoke.lp_iterate_operands(ops, dev)
        ref = lp_place.lp_iterate_reference(logits, cap, req_aug, iters=200, tol=1e-3)
        ref = ([ref[0]], ref[1], ref[2])
        default = lp_place.lp_plan(rows, 1024, cap.shape[1], 1, sms)
        rec = {"rows": rows, "default": default.mode}
        for mode in ("rows", "tiles"):
            p = lp_place.lp_plan(rows, 1024, cap.shape[1], 1, sms, mode=mode)

            def run(p=p):
                return lp_place._solve([logits], [cap], req_aug, iters=200, tol=1e-3, plan=p)

            check(smoke, run(), ref, f"plan rule {rows} rows: {mode}", failures)
            ms, _, _ = timed(smoke, run, opts.repeats)
            rec[mode] = {**smoke.lp_plan_record(p), "ms": ms}
        torch.cuda.synchronize()
        emit({"phase": "plan_rule", **rec}, out)
        rule.append({"rows": rows, "default": rec["default"], "rows_ms": rec["rows"]["ms"],
                     "tiles_ms": rec["tiles"]["ms"], "tiles_tn": rec["tiles"]["tn"]})
    return rule


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--pods", type=int, default=100_000)
    ap.add_argument("--tasks-per-job", type=int, default=100)
    ap.add_argument("--config2-nodes", type=int, default=1000)
    ap.add_argument("--config2-pods", type=int, default=5000)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lp_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from scheduler_tpu_torch.ops import cuda_build, lp_place

    out = []
    opts.work = tempfile.mkdtemp(prefix="lp_ab_")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "sms": lp_place.device_sms(dev)}, out)
    t0 = time.perf_counter()
    base = Base(build_base(os.path.abspath(opts.base)))
    cuda_build.load()
    clock_lib = cuda_build.load_variant(["lp_relax.cu"], ["LP_PHASE_CLOCKS"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0}, out)
    cases = opts.cases.split(",")
    calls = {}
    if "r" in cases:
        calls["r"] = capture(smoke, opts, "r")
    if {"r'", "tight", "blocks"} & set(cases):
        rp = capture(smoke, opts, "r'")
        shape, cols, iters, tol = rp[0].shape, rp[1].shape[1], rp[3], rp[4]
        if "r'" in cases:
            calls["r'"] = rp
        if "tight" in cases:
            ops = smoke.lp_operands(smoke.LP_TIGHT_SEED, shape[0], shape[1], cols - 1,
                                    tight=True)
            calls["tight"] = (*smoke.lp_iterate_operands(ops, dev), iters, tol)
        if "blocks" in cases:
            calls["blocks"] = smoke.split_lp_call(rp, smoke.MESH_SHARDS)
    if "cols16_classes" in cases:
        seed, rows, n, r_dim = COLS16_CLASSES
        ops = smoke.lp_operands(seed, rows, n, r_dim, classes=True)
        calls["cols16_classes"] = (*smoke.lp_iterate_operands(ops, dev), 200, 1e-3)
    summary = {"nvidia_smi": card, "cases": {}}
    failures = []
    for case in cases:
        logits, cap, req_aug, iters, tol = calls[case]
        blocks = case == "blocks"
        if blocks:
            logits_b, cap_b = logits, cap
            rows, n = logits_b[0].shape
            d = len(logits_b)
        else:
            logits_b, cap_b = [logits], [cap]
            rows, n = logits.shape
            d = 1
        r = cap_b[0].shape[1]
        plan = lp_place.lp_plan(rows, n, r, d, lp_place.device_sms(dev))

        def run_base():
            if blocks:
                return base.solve_blocks(logits_b, cap_b, req_aug, iters, tol)
            return base.solve(logits, cap, req_aug, iters, tol)

        def run_new(p=None, lib=None, clocks=None):
            return lp_place._solve(logits_b, cap_b, req_aug, iters=iters, tol=tol,
                                   plan=p or plan, blocks=blocks, lib=lib, clocks=clocks)

        if blocks:
            ref = lp_place.lp_iterate_blocks_reference(logits_b, cap_b, req_aug, iters=iters,
                                                       tol=tol)
        else:
            x_p, pref_p, raw_p = lp_place.lp_iterate_reference(logits, cap, req_aug,
                                                               iters=iters, tol=tol)
            ref = ([x_p], pref_p, raw_p)
        got_b, got_n = run_base(), run_new()
        again = run_new()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got_n[0] + [got_n[1], got_n[2]],
                                      again[0] + [again[1], again[2]]))
        if not bitwise:
            failures.append(f"{case}: two runs of the new kernel differ")
        # cols16_classes: within COLS16_OVER_TOL (both kernels' readings are
        # recorded), and against the float64 solve below.
        limit = COLS16_OVER_TOL if case == "cols16_classes" else 1.0
        errs = {"new_vs_plain": check(smoke, got_n, ref, f"{case}: new against plain", failures,
                                      limit),
                "base_vs_plain": check(smoke, got_b, ref, f"{case}: base against plain",
                                       failures, limit),
                "new_vs_base": check(smoke, got_n, got_b, f"{case}: new against base", failures,
                                     limit)}
        if case == "cols16_classes":
            x64 = lp_place.lp_iterate_reference(logits.cpu().double(), cap.cpu().double(),
                                                req_aug.cpu().double(), iters=iters, tol=tol)[0]

            def off(x):
                return smoke.lp_marginal_errors(x.cpu().double(), x64)["over_tol"]

            errs["over_tol_vs_float64"] = {"new": off(got_n[0][0]), "base": off(got_b[0][0]),
                                           "plain": off(ref[0][0])}
            if errs["over_tol_vs_float64"]["new"] > errs["over_tol_vs_float64"]["plain"] + 1.0:
                failures.append(f"{case}: new farther from float64 than plain plus one limit: "
                                f"{errs['over_tol_vs_float64']}")
        x = torch.cat(got_n[0], dim=1)
        lib_ms, _, _ = timed(smoke, lambda: torch.matmul(x.T, req_aug), 20)
        b_ms, b_dev, b_names = timed(smoke, run_base, opts.repeats)
        emit({"phase": "base_passes", "case": case, "rows": rows, "n": n * d, "blocks": d,
              "cols": r, "iters": iters, "ms": b_ms, "device_ms": b_dev, "by_kernel": b_names,
              "matmul_load_ms": lib_ms}, out)
        turns = []
        for who in ("base", "new", "new", "base"):
            ms, dev_ms, names = timed(smoke, run_base if who == "base" else run_new,
                                      opts.repeats)
            launches = sum(v["launches"] for k, v in names.items() if "lp_" in k)
            turns.append({"kernel": who, "ms": ms, "device_ms": dev_ms,
                          "kernel_launches": launches})
            if who == "new" and launches != 1:
                failures.append(f"{case}: the profiler counted {launches} launches a solve of "
                                f"the new kernel")
        bound = smoke.lp_bound_ms(rows, n * d, r, iters)
        clocks = torch.zeros(len(lp_place.PHASES) + 2, dtype=torch.int64, device=dev)
        check(smoke, run_new(lib=clock_lib, clocks=clocks), ref, f"{case}: clock build", failures,
              limit)
        torch.cuda.synchronize()
        c = clocks.tolist()
        phase_clocks = {"phases": dict(zip(lp_place.PHASES, c[:len(lp_place.PHASES)])),
                        "total_clocks": c[-2], "ns": c[-1]}
        rec = {"phase": "ab", "case": case, "rows": rows, "n": n * d, "blocks": d, "cols": r,
               "iters": iters, "plan": smoke.lp_plan_record(plan), "turns": turns,
               "bitwise_rerun": bitwise, **errs, "evidence": got_n[2].tolist(),
               "matmul_load_ms": lib_ms, "phase_clocks": phase_clocks, **bound}
        new_ms = [t["ms"] for t in turns if t["kernel"] == "new"]
        base_ms = [t["ms"] for t in turns if t["kernel"] == "base"]
        rec["speedup"] = min(base_ms) / max(new_ms)
        emit(rec, out)
        summary["cases"][case] = {"plan": smoke.lp_plan_record(plan), "new_ms": new_ms,
                                  "base_ms": base_ms, "speedup": rec["speedup"],
                                  "bound_ms": bound["bound_ms"],
                                  "kernel_launches": [t["kernel_launches"] for t in turns],
                                  "base_by_kernel": {k: v["ms"] for k, v in b_names.items()},
                                  "phase_clocks": phase_clocks}
        if case == "cols16_classes":
            summary["cases"][case]["over_tol"] = errs
            continue
        forced = []
        for name, kw in (("rows_batch8", dict(mode="rows", batch=8)),
                         ("rows_batch4", dict(mode="rows", batch=4)),
                         ("rows_no_logits_on_chip", dict(mode="rows", l_rows=0)),
                         ("tiles_128", dict(mode="tiles", tn=128)),
                         ("tiles_256", dict(mode="tiles", tn=256)),
                         ("tiles_1024", dict(mode="tiles", tn=1024))):
            try:
                p = lp_place.lp_plan(rows, n, r, d, lp_place.device_sms(dev), **kw)
            except ValueError as e:
                forced.append({"plan": name, "skipped": str(e)})
                continue
            if not p.resident:
                forced.append({"plan": name, "skipped": f"{p.ctas} CTAs"})
                continue
            held = check(smoke, run_new(p), ref, f"{case}: plan {name}", failures)["held"]
            ms, dev_ms, _ = timed(smoke, lambda: run_new(p), opts.repeats)
            forced.append({"plan": name, **smoke.lp_plan_record(p), "ms": ms, "device_ms": dev_ms,
                           "held": held})
        emit({"phase": "forced_plans", "case": case, "default_ms": min(new_ms),
              "plans": forced}, out)
        summary["cases"][case]["forced_ms"] = {p["plan"]: p.get("ms") for p in forced}
    summary["plan_rule"] = plan_rule(smoke, lp_place, dev, opts, out, failures)
    if "r'" in summary["cases"] and "blocks" in summary["cases"]:
        summary["blocks_over_one_device"] = (min(summary["cases"]["blocks"]["new_ms"])
                                             / min(summary["cases"]["r'"]["new_ms"]))
    summary["phase"] = "summary"
    summary["failures"] = failures
    emit(summary, out)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in out) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
