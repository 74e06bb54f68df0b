#!/usr/bin/env python3
"""Path q' of ``chip_smoke.py`` (the churn rig on the daemon's event loop, at
``chip_smoke.CHURN_CARD``) at each arrival rate given: does the rig drain,
how many 410 relists did the reflectors pay, the cycle p50 / p99, and the
server's store after (``harness.wire_rig.churn_state``).  Each of the rig's
three drains (two warmup slices, then the measured window) waits at most
``--drain-cap`` seconds.

    python3 scripts/churn_rates.py --rate 500 --rate 1000 --rate 2000

Run on a machine with an NVIDIA GPU, from the root of a checkout.  Prints
the card's name and power limit, then one JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class LogCounts(logging.Handler):
    """Counts the port's log records that tell of bind trouble: the cache's
    violated assertions (a pod added to a node without the room), bind POSTs
    sent again, and binds given up and resynced."""

    KEYS = {"assertion violated": "asserts", "sending it again": "bind_resends",
            "failed; resyncing": "bind_resyncs"}

    def __init__(self):
        super().__init__(logging.WARNING)
        self.reset()

    def reset(self):
        self.counts = dict.fromkeys(self.KEYS.values(), 0)

    def emit(self, record):
        msg = str(record.msg)
        for key, name in self.KEYS.items():
            if key in msg:
                self.counts[name] += 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rate", type=float, action="append", required=True,
                        help="arrivals a second")
    parser.add_argument("--drain-cap", type=float, default=60.0)
    opts = parser.parse_args()

    import chip_smoke as cs
    import scheduler_tpu_torch.actions  # noqa: F401
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.connector.mock_server import MockState
    from scheduler_tpu_torch.harness import churn
    from scheduler_tpu_torch.harness.wire_rig import churn_state

    logs = LogCounts()
    logging.getLogger("scheduler_tpu_torch").addHandler(logs)
    wait = churn._wait_drained
    churn._wait_drained = lambda sched, trigger, timeout: wait(
        sched, trigger, min(timeout, opts.drain_cap))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    conf_path = os.path.join(ROOT, "chiprun_out", "churn_rates_conf.yaml")
    os.makedirs(os.path.dirname(conf_path), exist_ok=True)
    with open(conf_path, "w") as f:
        f.write(cs.CONFIG1_CONF)
    cs.run_cycle(cs.config1_cluster(), conf_path)  # warms the card up
    for rate in opts.rate:
        state = MockState()
        cs.reset_counts()
        logs.reset()
        t0 = time.perf_counter()
        rec = {"rate": rate}
        try:
            doc = churn.run_churn_bench(churn.ChurnConfig(**dict(cs.CHURN_CARD, rate=rate)),
                                        wire="k8s", state=state)
            d = doc["detail"]
            rec.update(drained=d["cycles_measured"] > 0, p50_ms=d["p50_ms"],
                       p99_ms=d["p99_ms"], max_ms=d["max_ms"],
                       cycles=d["cycles_measured"], relists=d["ingest"]["relists"],
                       relist_bytes=d["ingest"]["relist_bytes"], replay=d["replay"])
        except RuntimeError as exc:  # a warmup slice that never drained
            rec.update(drained=False, error=str(exc))
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = cs.read_counts()[0]["mega_allocate"]
        faults, bound, pending = churn_state(state)
        rec.update(server_bound=bound, server_pending=pending, server_faults=faults,
                   logs=logs.counts)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
