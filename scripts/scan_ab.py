#!/usr/bin/env python3
"""Time ``place_scan`` of an earlier checkout against this one's, on one card.

    python3 scripts/scan_ab.py --base DIR [--pops N] [--repeats R] [--configs A,B]

builds ``DIR/scheduler_tpu_torch/csrc/place_scan.cu`` (the root of a
checkout: an unpacked earlier commit) into a library of its own beside
this checkout's kernels, captures the per-pop engine's first ``--pops``
pops of a main path of this checkout (``chip_smoke.ScanCapture`` around one
``Scheduler.run_once`` on the card), replays them in order from the
engine's starting node state, and on each pop's operands runs the two
kernels in turns (base, new, new, base), ``--repeats`` launches a turn
with the node state restored before each:

* ``production_conf`` (path n): ``deploy/scheduler-conf.yaml`` on config
  3's cluster, 10,000 nodes x 100,000 pods in gangs of 100;
* ``config2_default_tiers_device`` (path n'): config 2 under the JAX
  default tiers with ``SCHEDULER_TORCH_FUSED_STATIC_LIMIT=1``, 1,000 nodes,
  one-task pops.

A launch is timed two ways, the same for both kernels: CUDA events around
the C call (host submission included) and the profiler's device time of
the kernel (``chip_smoke.device_ms_per_call``).  Each pop's codes and
written node state must be bitwise equal between the two kernels.  Then
this checkout's kernel on the first pop of each path under every launch
plan that fits (``place_scan_kernel.scan_plan`` forced: 1 to 16 CTAs, the
shared and the global arm), and built with ``-DSCAN_PHASE_CLOCKS`` on the
same pop: a task's SM clocks in each phase of the loop.  Prints one JSON
line per pop and one summary JSON line, last.  The base's entry point is
the one-block kernel's ``place_scan_launch`` or, in a later checkout,
``place_scan_cluster_launch`` with the wrapper's plan.  Needs a CUDA
device; exits 2 without one.
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

PLANS = [(c, arm) for c in (1, 2, 4, 8, 16) for arm in ("shared", "global")]


def base_entry(lib):
    """(kind, entry) of the base library: ``legacy`` for the one-block
    kernel's entry point, ``cluster`` for one that takes a plan."""
    if hasattr(lib, "place_scan_cluster_launch"):
        fn = lib.place_scan_cluster_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        return "cluster", fn
    fn = lib.place_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return "legacy", fn


def launcher(psk, kind, fn, dyn, rest, clocks=None):
    """A call of ``fn`` (an entry point of ``kind``) on one pop's operands:
    the node state ``dyn`` and the wrapper's other arguments ``rest``
    (``clocks``: the phase clocks' output of a cluster entry point)."""
    import torch

    idle, rel, tc = dyn
    (alloc, plim, mins, initq, req, smask, sscore, rows, deficit, weights, enforce,
     n_active) = rest
    t = int(rows.shape[0])
    r = int(idle.shape[1])
    out = torch.empty((3, t), dtype=torch.int32, device=idle.device)
    plan = psk.scan_plan(n_active, r, t, weights, enforce)
    ptrs = [idle.data_ptr(), rel.data_ptr(), tc.data_ptr(), alloc.data_ptr(), plim.data_ptr(),
            mins.data_ptr(), initq.data_ptr(), req.data_ptr(), smask.data_ptr(),
            sscore.data_ptr() if sscore is not None else None, rows.data_ptr(),
            out.data_ptr(), smask.stride(0), t, n_active, r, int(deficit), int(bool(enforce)),
            *(float(w) for w in weights)]
    stream = torch._C._cuda_getCurrentRawStream(idle.device.index)

    def call():
        if kind == "legacy":
            rc = fn(*ptrs, stream)
        else:
            rc = fn(*ptrs, plan.ctas, plan.threads, plan.slice, int(plan.on_chip),
                    plan.smem_bytes, stream, None, None,
                    clocks.data_ptr() if clocks is not None else None)
        if rc != 0:
            raise RuntimeError(f"scan_ab: the {kind} kernel failed: CUDA error {rc}")
        return out

    return call


PHASE_NAMES = ("head", "pass", "warps_and_barrier", "cta_pair_fits_push", "slot_wait",
               "merge_decide_apply", "closing_barrier")


def phase_split(smoke, psk, lib, capture, repeats):
    """This checkout's kernel built with -DSCAN_PHASE_CLOCKS on the first
    captured pop (the wrapper's plan): thread 0 of rank 0's SM clocks a
    task in each phase of the loop, and the loop's ns a task."""
    import torch

    dyn, fixed = capture.start_state()
    rest = fixed + capture.operands(0)
    saved = [x.clone() for x in dyn]
    clocks = torch.zeros(len(PHASE_NAMES) + 3, dtype=torch.int64, device=dyn[0].device)
    call = launcher(psk, "cluster", base_entry(lib)[1], dyn, rest, clocks)
    total = torch.zeros_like(clocks)
    for _ in range(repeats):
        for x, y in zip(dyn, saved):
            x.copy_(y)
        call()
        torch.cuda.synchronize()
        total += clocks
    c = (total.double() / repeats).tolist()
    tasks = max(c[-1], 1.0)
    per = {name: c[i] / tasks for i, name in enumerate(PHASE_NAMES)}
    return {"clocks_per_task": per, "loop_clocks_per_task": c[len(PHASE_NAMES)] / tasks,
            "loop_ns_per_task": c[len(PHASE_NAMES) + 1] / tasks, "tasks": c[-1]}


def timed(smoke, call, restore, repeats):
    """Events around each of ``repeats`` calls and the profiler's device
    time a call, the node state restored before each."""
    import torch

    e0, e1 = smoke.events()
    total = 0.0
    for _ in range(repeats):
        restore()
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)

    def one():
        restore()
        return call()

    device_ms, _ = smoke.device_ms_per_call(one, repeats, match="place_scan_kernel")
    torch.cuda.synchronize()
    return {"event_ms": total / repeats, "device_ms": device_ms}


def capture_path(smoke, name, pops):
    """The per-pop engine's first ``pops`` pops of main path ``name``."""
    from scheduler_tpu_torch.harness import make_kubemark_density_cluster, make_synthetic_cluster

    with tempfile.TemporaryDirectory() as tmp:
        conf_path = os.path.join(tmp, "conf.yaml")
        if name == "production_conf":
            conf_path = os.path.join(ROOT, smoke.PRODUCTION_CONF)
            cache = make_synthetic_cluster(10_000, 100_000, tasks_per_job=100).cache
        else:
            os.environ["SCHEDULER_TORCH_FUSED_STATIC_LIMIT"] = "1"
            with open(conf_path, "w") as f:
                f.write(smoke.DEFAULT_TIERS_CONF)
            cache = make_kubemark_density_cluster(1000, 5000).cache
        with smoke.ScanCapture(pops) as capture:
            rec, launches = smoke.run_cycle(cache, conf_path, engine="device")
        os.environ.pop("SCHEDULER_TORCH_FUSED_STATIC_LIMIT", None)
    return capture, {"cycle_s": rec["cycle_s"], "pops": rec["cohort"]["pops"],
                     "kernel_ms": rec["kernel_ms"], "wrapper_ms": rec["cohort"].get("wrapper_ms"),
                     "split": smoke.device_pops_split(rec)}


def ab_path(smoke, psk, name, capture, base, repeats):
    """Both kernels on each captured pop, in turns; returns per-pop records."""
    import torch

    kind, fn = base
    dyn, fixed = capture.start_state()
    recs = []
    for i, (spec, result) in enumerate(capture.pops):
        rest = fixed + capture.operands(i)
        saved = [x.clone() for x in dyn]
        work = [x.clone() for x in dyn]

        def restore():
            for x, y in zip(work, saved):
                x.copy_(y)

        calls = {"base": launcher(psk, kind, fn, work, rest),
                 "new": lambda: psk.place_scan(*work, *rest)}
        turns = {"base": [], "new": []}
        for who in ("base", "new", "new", "base"):
            turns[who].append(timed(smoke, calls[who], restore, repeats))
        outs = {}
        for who in ("base", "new"):
            restore()
            codes = calls[who]().clone()
            torch.cuda.synchronize()
            outs[who] = (codes, [x.clone() for x in work])
        same = torch.equal(outs["base"][0], outs["new"][0]) and all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(outs["base"][1], outs["new"][1]))
        if not same:
            raise SystemExit(f"scan_ab: {name} pop {i}: the kernels disagree")
        codes = outs["new"][0]
        scanned = int((codes[0] >= 0).sum()) + int(codes[2].sum())
        for x, y in zip(dyn, outs["new"][1]):
            x.copy_(y)  # the state after this pop, for the next
        rec = {"phase": "scan_ab_pop", "path": name, "pop": i, "tasks": int(spec.rows.shape[0]),
               "scanned": scanned, "same_result": True}
        for who in ("base", "new"):
            dev = [x["device_ms"] for x in turns[who] if x["device_ms"] is not None]
            ev = [x["event_ms"] for x in turns[who]]
            rec[who] = {"event_ms": ev, "device_ms": dev,
                        "us_per_task": (1e3 * sum(dev) / len(dev) / max(scanned, 1)
                                        if dev else None)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def plan_sweep(smoke, psk, capture, repeats):
    """This checkout's kernel on the first captured pop under every plan
    that fits: device ms and equal codes across plans.  Returns (the
    wrapper's plan, {plan: record})."""
    import torch

    dyn, fixed = capture.start_state()
    rest = fixed + capture.operands(0)
    saved = [x.clone() for x in dyn]
    n_active, r = int(rest[-1]), int(dyn[0].shape[1])
    t = int(rest[7].shape[0])
    weights, enforce = rest[9], rest[10]
    out, ref = {}, None

    def restore():
        for x, y in zip(dyn, saved):
            x.copy_(y)

    for ctas, arm in PLANS:
        try:
            plan = psk.scan_plan(n_active, r, t, weights, enforce, ctas, arm)
        except ValueError:
            continue
        rec = timed(smoke, lambda: psk.place_scan(*dyn, *rest, plan=plan), restore, repeats)
        restore()
        codes = psk.place_scan(*dyn, *rest, plan=plan)
        torch.cuda.synchronize()
        ref = codes.clone() if ref is None else ref
        rec["same_codes"] = bool(torch.equal(codes, ref))
        out[f"{ctas}_{arm}"] = rec
    return psk.scan_plan(n_active, r, t, weights, enforce).describe(), out


def mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True)
    parser.add_argument("--pops", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--configs", default="production_conf,config2_default_tiers_device")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.ops import cuda_build
    from scheduler_tpu_torch.ops import place_scan_kernel as psk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cuda_build.load()
    base_src = os.path.join(os.path.abspath(opts.base), "scheduler_tpu_torch", "csrc",
                            "place_scan.cu")
    base = base_entry(cuda_build.load_variant([base_src], ()))
    clocked = cuda_build.load_variant(["place_scan.cu"], ("SCAN_PHASE_CLOCKS",))
    out = {"gpu": smi, "base": opts.base, "base_entry": base[0], "pops": opts.pops,
           "repeats": opts.repeats}
    for name in opts.configs.split(","):
        capture, cycle = capture_path(smoke, name, opts.pops)
        recs = ab_path(smoke, psk, name, capture, base, opts.repeats)
        first = recs[0]
        summary = {"cycle": cycle, "first_pop_tasks": first["scanned"]}
        for who in ("base", "new"):
            summary[who] = {
                "first_pop_device_ms": mean(first[who]["device_ms"]),
                "first_pop_event_ms": mean(first[who]["event_ms"]),
                "first_pop_us_per_task": first[who]["us_per_task"],
                "turns_first_pop_device_ms": first[who]["device_ms"],
                "pops_device_ms_mean": mean([mean(r[who]["device_ms"]) for r in recs]),
                "pops_event_ms_mean": mean([mean(r[who]["event_ms"]) for r in recs]),
            }
        b, n = summary["base"]["first_pop_device_ms"], summary["new"]["first_pop_device_ms"]
        summary["speedup_first_pop"] = b / n if b and n else None
        summary["default_plan"], summary["plans"] = plan_sweep(smoke, psk, capture,
                                                              opts.repeats)
        summary["phases"] = phase_split(smoke, psk, clocked, capture, opts.repeats)
        out[name] = summary
        del capture
        gc.collect()
    out["at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
