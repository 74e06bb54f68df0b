#!/usr/bin/env python3
"""Time ``qfair_solve`` of an earlier checkout against this one's, on one card.

    python3 scripts/qfair_ab.py --base DIR [--repeats R]

builds ``DIR/scheduler_tpu_torch/csrc/qfair_solve.cu`` (the root of a
checkout: an unpacked earlier commit, whose kernel is one warp, with the
entry point ``qfair_solve_launch(w, req, total, req_hs, mins, d_hs,
total_hs, q_n, r_n, iters, d, met, qf_raw, stream)``) into a library of its
own beside this checkout's kernels, and runs the two kernels in turns
(base, new, new, base), ``--repeats`` launches a turn, on:

* the qfair ladder flagship's water-fill (path g: proportion's operands of
  a session of ``harness.make_mq_ladder_cluster(10_000, 100_000, 100, 6)``
  under the multi-queue conf, 100 queues x 8 dims);
* random fleets (``chip_smoke.qfair_fleet``) of 33 x 3, 300 x 8 and
  1,100 x 8.

A launch is timed two ways, the same for both kernels: CUDA events around
the launches of a turn over their count, and the profiler's device time of
the kernel (``chip_smoke.device_ms_per_call``).  The two kernels' deserved
rows, met flags and evidence must be bitwise equal.  Beside each fleet,
the chain floor of this checkout's design: rounds x 2 x Q x the latency of
a dependent float64 add (``dadd_chain_clocks``: one thread's chain of
adds between two reads of the SM clock, a probe kernel built here) at the
card's highest SM clock (nvidia-smi).  ``chip_smoke.DADD_NS`` holds the
latency this script measured.  Prints one JSON line per fleet and one
summary JSON line, last.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FLEETS = ((33, 3, 11), (300, 8, 14), (1100, 8, 15))

# The probe: one thread runs ``adds`` dependent float64 adds between two
# reads of the SM clock; out[0] the clocks, out[1] the sum (so the chain is
# not folded).
DADD_PROBE_CU = r"""
#include <cuda_runtime.h>

__global__ void dadd_chain_kernel(const double* x, long long* out, int adds) {
  double acc = x[0];
  const double y = x[1];
  const long long t0 = clock64();
  for (int i = 0; i < adds; ++i) acc = __dadd_rn(acc, y);
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = __double_as_longlong(acc);
}

extern "C" int dadd_chain_probe(const double* x, long long* out, int adds, void* stream) {
  cudaGetLastError();
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, out, adds);
  return (int)cudaGetLastError();
}
"""


def base_launcher(tree):
    """The earlier checkout's one-warp entry point, built alone."""
    from scheduler_tpu_torch.ops import cuda_build

    src = os.path.join(tree, "scheduler_tpu_torch", "csrc", "qfair_solve.cu")
    out_dir = cuda_build._build_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"base-qfair-{cuda_build._digest([src])}.so")
    if not os.path.exists(path):
        cuda_build._compile([src], out_dir, path, False)
    fn = ctypes.CDLL(path).qfair_solve_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int

    def solve(weights, request, total, req_hs, total_hs, mins, *, iters):
        import torch

        q_n, r_n = request.shape
        dev = request.device
        deserved = torch.empty((q_n, r_n), dtype=torch.float64, device=dev)
        met = torch.empty(q_n, dtype=torch.bool, device=dev)
        d_hs = torch.empty(q_n, dtype=torch.bool, device=dev)
        qf_raw = torch.empty(2, dtype=torch.int32, device=dev)
        rc = fn(weights.data_ptr(), request.data_ptr(), total.data_ptr(), req_hs.data_ptr(),
                mins.data_ptr(), d_hs.data_ptr(), int(bool(total_hs)), q_n, r_n, int(iters),
                deserved.data_ptr(), met.data_ptr(), qf_raw.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"base qfair_solve launch failed: CUDA error {rc}")
        return deserved, met, qf_raw

    return solve


def dadd_chain_clocks(device, adds=4096):
    """SM clocks a dependent float64 add takes on the card (the probe,
    built into a library of its own)."""
    import torch

    from scheduler_tpu_torch.ops import cuda_build

    out_dir = cuda_build._build_dir()
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "dadd_chain_probe.cu")
    with open(src, "w") as f:
        f.write(DADD_PROBE_CU)
    path = os.path.join(out_dir, f"dadd-probe-{cuda_build._digest([src])}.so")
    if not os.path.exists(path):
        cuda_build._compile([src], out_dir, path, False)
    fn = ctypes.CDLL(path).dadd_chain_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.tensor([1.0, 1e-9], dtype=torch.float64, device=device)
    out = torch.zeros(2, dtype=torch.int64, device=device)
    rc = fn(x.data_ptr(), out.data_ptr(), int(adds), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dadd_chain_probe failed: CUDA error {rc}")
    return float(out[0].item()) / adds


def sm_max_mhz():
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.split()[0])


def ladder_fleet(smoke, device):
    """Proportion's water-fill operands of a ladder flagship session."""
    from scheduler_tpu_torch.conf import parse_scheduler_conf
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.harness import make_mq_ladder_cluster

    cache = make_mq_ladder_cluster(smoke.LADDER_NODES, smoke.LADDER_PODS, smoke.LADDER_QUEUES,
                                   smoke.LADDER_VOCAB).cache
    ssn = open_session(cache, parse_scheduler_conf(smoke.MULTIQ_CONF).tiers)
    ops = smoke.proportion_solve_operands(ssn, device)
    close_session(ssn)
    return ops


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="root of the earlier checkout")
    parser.add_argument("--repeats", type=int, default=50)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qfair_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.ops import qfair as qf

    device = torch.device("cuda")
    kernels = {"base": base_launcher(os.path.abspath(opts.base)), "new": qf.qfair_solve}
    fleets = [("mq_ladder", ladder_fleet(smoke, device))]
    fleets += [(f"random_{q}q_{r}r", smoke.qfair_fleet(q, r, seed, device))
               for q, r, seed in FLEETS]
    clocks, mhz = dadd_chain_clocks(device), sm_max_mhz()
    summary = {"card": smoke.nvidia_smi_line(), "base": os.path.abspath(opts.base),
               "repeats": opts.repeats, "dadd_clocks": clocks, "sm_max_mhz": mhz,
               "dadd_ns": 1e3 * clocks / mhz, "fleets": {}}
    ok = True
    for name, ops in fleets:
        iters = int(ops[1].shape[0]) + 4
        outs, turns = [], []
        for label in ("base", "new", "new", "base"):
            solve = kernels[label]
            got = solve(*ops, iters=iters)
            start, stop = smoke.events()
            start.record()
            for _ in range(opts.repeats):
                solve(*ops, iters=iters)
            stop.record()
            torch.cuda.synchronize()
            device_ms, _ = smoke.device_ms_per_call(lambda: solve(*ops, iters=iters),
                                                    opts.repeats, match="qfair_solve_kernel")
            outs.append(got)
            turns.append({"arm": label, "event_ms": start.elapsed_time(stop) / opts.repeats,
                          "device_ms": device_ms})
        equal = all(torch.equal(o[0].view(torch.int64), outs[0][0].view(torch.int64))
                    and torch.equal(o[1], outs[0][1]) and torch.equal(o[2], outs[0][2])
                    for o in outs)
        ok = ok and equal
        rec = {"fleet": name, "queues": int(ops[1].shape[0]), "dims": int(ops[1].shape[1]),
               "converged_at": int(outs[0][2][1]), "equal": equal, "turns": turns,
               "plan": dict(zip(("threads", "on_chip", "smem_bytes"),
                                qf.qfair_plan(*ops[1].shape)))}
        for key in ("event_ms", "device_ms"):
            for label in ("base", "new"):
                vals = [t[key] for t in turns if t["arm"] == label and t[key] is not None]
                rec[f"{label}_{key}"] = sum(vals) / len(vals) if vals else None
        rec["bound_ms"], rec["bound_by"] = smoke.qfair_bound_ms(ops, outs[0][2])
        rounds = max(0, int(outs[0][2][1]))
        rec.update(rounds=rounds, chain_floor_ms=rounds * 2 * rec["queues"] * clocks / (mhz * 1e3))
        print(json.dumps(rec), flush=True)
        summary["fleets"][name] = rec
    print(json.dumps(summary), flush=True)
    if not ok:
        print("qfair_ab: the two kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
