"""Churn traffic simulator: sustained watch-event load against a
mostly-placed cluster (the design is in ``docs/CHURN.md``; the port's own
copy of ``scheduler_tpu/harness/churn.py``).

A cold batch cycle is not what a serving cluster sees: pods arrive and die
at 1-10k events/s against a cluster that is already mostly placed, ingested
as a continuous watch stream.  This module generates that traffic and
drives it through the real wire: seeded events applied to the mock API
server's store, echoed over its journal/k8s watch streams, consumed by the
connector into the cache, pacing the scheduler loop through the event
trigger (``utils/trigger.py``).

Pieces, each usable alone:

* ``make_history(cfg)`` — a deterministic event history from a seed:
  Poisson pod arrivals (exponential inter-arrivals at the configured rate,
  multiplied during periodic bursts), per-pod exponential lifetimes that
  schedule the matching delete, and an exponential death process over the
  seeded placed population (delete churn on BOUND pods — the layout-stable
  case the engine cache's delta path serves).  Same seed, same history.
* ``seed_cluster(state, cfg)`` — preloads a mock API server's store with the
  mostly-placed cluster: nodes, gang podgroups of Running pods pinned to
  nodes, and a small pending backlog.
* ``apply_history_to_cache`` — the same history straight into a cache.
* ``run_churn_bench(cfg)`` — the full rig: server + connector +
  event-triggered scheduler, a warmup slice (the first cycles of each task
  bucket build engines; the measured window must not pay them), then the
  measured wall-clock replay.  Returns the sustained event rate, per-cycle
  event batch sizes, engine-cache outcomes, dirty-row evidence, and p50/p99
  cycle latency.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

MIB = 1024.0 * 1024.0
GIB = 1024.0 * MIB

# Scheduling conf for the churn rig: the bench scenario's allocate-only
# action list (arrival pods ride shadow PodGroups, which are born Inqueue).
CHURN_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: binpack
"""


@dataclass
class ChurnConfig:
    seed: int = 0
    nodes: int = 200
    placed_pods: int = 2000        # seeded Running pods (the placed mass)
    pending_pods: int = 32         # seeded pending backlog
    tasks_per_job: int = 50        # gang size of the seeded placed jobs
    rate: float = 1000.0           # sustained arrival rate, events/s
    duration_s: float = 5.0        # measured replay window
    warm_s: float = 1.5            # warmup replay (engine builds excluded)
    lifetime_s: float = 8.0        # mean lifetime of an arriving pod
    placed_lifetime_s: float = 120.0  # mean lifetime of a seeded placed pod
    burst_every_s: float = 2.0     # burst cadence
    burst_len_s: float = 0.25      # burst width
    burst_factor: float = 4.0      # rate multiplier inside a burst
    # Arrivals round-robin into this many pre-created min_member=1
    # PodGroups ("churn lanes"): the realistic shape (volcano workloads
    # arrive under PodGroups), and it keeps the job table bounded — bare
    # pods would synthesize one shadow job per arrival.
    lanes: int = 16
    max_interval_s: float = 0.25   # quiet-cluster rescan clamp
    node_cpu_milli: float = 64_000.0
    node_memory: float = 256.0 * GIB
    namespace: str = "default"


@dataclass
class ChurnEvent:
    t: float      # seconds from history start
    kind: str     # "pod"
    op: str       # add | delete
    obj: dict = field(default_factory=dict)


def _pod_request(i: int) -> Dict[str, float]:
    """Small deterministic mixed requests — churn pods must not exhaust the
    mostly-placed cluster's remaining headroom."""
    return {
        "cpu": [100.0, 200.0, 250.0, 500.0][i % 4],
        "memory": [64.0, 128.0, 256.0, 512.0][(i // 4) % 4] * MIB,
    }


def _node_name(cfg: ChurnConfig, i: int) -> str:
    return f"cn-{i % cfg.nodes:05d}"


def _in_burst(cfg: ChurnConfig, t: float) -> bool:
    return cfg.burst_every_s > 0 and (t % cfg.burst_every_s) < cfg.burst_len_s


def make_history(cfg: ChurnConfig, tag: str = "churn") -> List[ChurnEvent]:
    """The seeded event history: a pure function of ``cfg`` (and ``tag``,
    which namespaces pod names so warmup and measured histories coexist in
    one server store).  Events are time-sorted."""
    rng = np.random.default_rng(cfg.seed if tag == "churn" else cfg.seed + 101)
    events: List[ChurnEvent] = []
    ns = cfg.namespace
    t = 0.0
    i = 0
    while True:
        r = cfg.rate * (cfg.burst_factor if _in_burst(cfg, t) else 1.0)
        t += float(rng.exponential(1.0 / max(r, 1e-9)))
        if t >= cfg.duration_s:
            break
        name = f"{tag}-{i:06d}"
        # The delete ident carries the group too: a real DELETED watch
        # event echoes the stored object, and the cache resolves the
        # owning job through the group annotation.
        ident = {"name": name, "namespace": ns, "uid": f"{ns}/{name}",
                 "group": f"lane-{i % cfg.lanes:02d}"}
        events.append(ChurnEvent(t, "pod", "add", {
            **ident,
            "containers": [_pod_request(i)],
            "phase": "Pending",
            "priority": i % 4,
        }))
        death = t + float(rng.exponential(cfg.lifetime_s))
        if death < cfg.duration_s:
            events.append(ChurnEvent(death, "pod", "delete", dict(ident)))
        i += 1
    # Death process over the seeded placed population: delete churn on BOUND
    # pods — frees node capacity without touching the pending layout, the
    # engine-cache hit + dirty-row-scatter case.  ONLY the measured history
    # runs it: the placed identities are fixed (not tag-namespaced), so a
    # warmup slice emitting these deletes would permanently thin the
    # mostly-placed mass before measurement.
    for j in range(cfg.placed_pods if tag == "churn" else 0):
        death = float(rng.exponential(cfg.placed_lifetime_s))
        if death < cfg.duration_s:
            group = f"placed-{j // cfg.tasks_per_job:04d}"
            name = f"{group}-{j % cfg.tasks_per_job:04d}"
            events.append(ChurnEvent(death, "pod", "delete", {
                "name": name, "namespace": ns, "uid": f"{ns}/{name}",
                "group": group,
            }))
    events.sort(key=lambda e: e.t)
    return events


def seed_cluster(state, cfg: ChurnConfig) -> None:
    """Preload a ``mock_server.MockState`` store with the mostly-placed
    cluster (no journal events: the connector's initial LIST seeds it)."""
    with state.lock:
        state.objects["queue"]["default"] = {"name": "default", "weight": 1}
        for i in range(cfg.nodes):
            name = f"cn-{i:05d}"
            state.objects["node"][name] = {
                "name": name,
                "allocatable": {
                    "cpu": cfg.node_cpu_milli,
                    "memory": cfg.node_memory,
                    "pods": 110,
                },
            }
        ns = cfg.namespace
        n_jobs = max(1, -(-cfg.placed_pods // cfg.tasks_per_job))
        idx = 0
        for j in range(n_jobs):
            size = min(cfg.tasks_per_job, cfg.placed_pods - j * cfg.tasks_per_job)
            if size <= 0:
                break
            group = f"placed-{j:04d}"
            state.objects["podgroup"][f"{ns}/{group}"] = {
                "name": group, "namespace": ns, "queue": "default",
                "minMember": size, "phase": "Running",
            }
            for k in range(size):
                name = f"{group}-{k:04d}"
                state.objects["pod"][f"{ns}/{name}"] = {
                    "name": name, "namespace": ns, "uid": f"{ns}/{name}",
                    "group": group,
                    "containers": [_pod_request(idx)],
                    "phase": "Running",
                    "nodeName": _node_name(cfg, idx),
                }
                idx += 1
        # Churn lanes: the PodGroups arrivals (and the seeded backlog) join.
        # min_member=1 — every member schedules independently, the arrival
        # semantics of a serving workload.
        for k in range(cfg.lanes):
            lane = f"lane-{k:02d}"
            state.objects["podgroup"][f"{ns}/{lane}"] = {
                "name": lane, "namespace": ns, "queue": "default",
                "minMember": 1, "phase": "Inqueue",
            }
        for p in range(cfg.pending_pods):
            name = f"backlog-{p:05d}"
            state.objects["pod"][f"{ns}/{name}"] = {
                "name": name, "namespace": ns, "uid": f"{ns}/{name}",
                "group": f"lane-{p % cfg.lanes:02d}",
                "containers": [_pod_request(p)],
                "phase": "Pending",
                "priority": p % 4,
            }


def seed_cache(cfg: ChurnConfig, vocab=None) -> "SchedulerCache":
    """The mostly-placed cluster seeded straight into a SchedulerCache (no
    wire) — the rig ``profile_cycle --churn`` and the dirty-set tests use.
    Mirrors ``seed_cluster`` through the SAME wire parsers, so the cache
    content matches what the connector would have ingested."""
    from scheduler_tpu_torch.cache.cache import SchedulerCache
    from scheduler_tpu_torch.connector.wire import (
        parse_node, parse_pod, parse_pod_group, parse_queue,
    )
    from scheduler_tpu_torch.connector.mock_server import MockState

    state = MockState()
    seed_cluster(state, cfg)
    cache = SchedulerCache(vocab=vocab, async_io=False)
    for q in state.objects["queue"].values():
        cache.add_queue(parse_queue(q))
    for n in state.objects["node"].values():
        cache.add_node(parse_node(n))
    for g in state.objects["podgroup"].values():
        cache.add_pod_group(parse_pod_group(g))
    for p in state.objects["pod"].values():
        cache.add_pod(parse_pod(p, cache.scheduler_name))
    return cache


def replay(state, history: List[ChurnEvent],
           stop: Optional[threading.Event] = None) -> dict:
    """Apply ``history`` against the mock server's store at wall-clock pace
    (events due now apply back-to-back; the loop sleeps only until the next
    due timestamp).  Returns the achieved input rate — the artifact's
    ``rate_sustained`` — and the peak scheduling lag of the applier."""
    t0 = time.monotonic()
    applied = 0
    max_lag = 0.0
    for ev in history:
        if stop is not None and stop.is_set():
            break
        now = time.monotonic() - t0
        if ev.t > now:
            time.sleep(ev.t - now)
        else:
            max_lag = max(max_lag, now - ev.t)
        state.apply(ev.kind, ev.op, dict(ev.obj))
        applied += 1
    elapsed = max(time.monotonic() - t0, 1e-9)
    return {
        "events": applied,
        "elapsed_s": round(elapsed, 3),
        "rate": round(applied / elapsed, 1),
        "max_lag_s": round(max_lag, 4),
    }


def apply_history_to_cache(cache, history: List[ChurnEvent]) -> int:
    """Apply a history slice straight to a SchedulerCache (no wire) — the
    seam ``profile_cycle --churn`` and the dirty-set parity tests use.
    Pod-only, like the histories ``make_history`` emits."""
    from scheduler_tpu_torch.connector.wire import parse_pod

    n = 0
    for ev in history:
        if ev.kind != "pod":
            continue
        pod = parse_pod(ev.obj, cache.scheduler_name)
        if ev.op == "add":
            cache.add_pod(pod)
        elif ev.op == "update":
            cache.update_pod(pod)
        else:
            cache.delete_pod(pod)
        n += 1
    return n


# -- the full bench rig (bench.py --churn) ------------------------------------


def _wait_drained(sched, trigger, timeout: float) -> bool:
    """Wait until the event-triggered scheduler has digested every applied
    event: no pending trigger batch, no cycle in flight, and the LAST
    completed cycle consumed zero events (a max-interval fallback ran after
    the final batch — proof the tail was processed, since fallback cycles
    only fire on an empty trigger).  Bounded by ``timeout`` — on a cold CPU
    the first cycles build engines that can individually take seconds."""
    deadline = time.monotonic() + timeout

    def drained() -> bool:
        log = sched.cycle_log
        return (
            trigger.pending() == 0 and not sched.in_cycle
            and bool(log) and log[-1]["events"] == 0
        )

    while time.monotonic() < deadline:
        if drained():
            # Double-check across a short gap: the flag flips are not one
            # atomic step with the pending consume.
            time.sleep(0.05)
            if drained():
                return True
        time.sleep(0.1)
    return False


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _cycle_stats(cycles: List[dict]) -> dict:
    lat_ms = [c["s"] * 1000.0 for c in cycles]
    events = [c["events"] for c in cycles]
    ec: Dict[str, int] = {}
    scattered = 0
    sparse = full = 0
    for c in cycles:
        status = c["notes"].get("engine_cache")
        if status is not None:
            ec[status] = ec.get(status, 0) + 1
        dirty = c["notes"].get("dirty")
        if dirty:
            if dirty.get("mode") == "sparse":
                sparse += 1
                scattered += max(0, dirty.get("rows_scattered", 0))
            else:
                full += 1
    judged = sum(ec.values())
    hit_rate = (ec.get("hit", 0) / judged) if judged else 0.0
    return {
        "cycles_measured": len(cycles),
        "p50_ms": round(_percentile(lat_ms, 50), 3),
        "p99_ms": round(_percentile(lat_ms, 99), 3),
        "max_ms": round(max(lat_ms), 3) if lat_ms else 0.0,
        "engine_cache": ec,
        "hit_rate": round(hit_rate, 4),
        "events_per_cycle": {
            "mean": round(float(np.mean(events)), 2) if events else 0.0,
            "p50": round(_percentile([float(e) for e in events], 50), 1),
            "max": max(events) if events else 0,
        },
        "fallback_cycles": sum(1 for e in events if e == 0),
        "dirty": {
            "sparse_cycles": sparse,
            "full_cycles": full,
            "rows_scattered": scattered,
        },
    }


def run_churn_bench(cfg: ChurnConfig, wire: Optional[str] = None,
                    hit_rate_floor: float = 0.0, device=None,
                    state=None) -> dict:
    """Run the churn scenario end to end and return the artifact body.

    The pacing knobs honor the environment (``CycleTrigger.from_env``), so
    an operator can A/B debounce settings; the trigger MODE is pinned to
    event pacing by constructor injection — the scenario exists to measure
    it.  ``wire`` pins the inbound protocol (None = ``SCHEDULER_TORCH_WIRE``,
    default k8s).  ``device`` is the scheduler's (None: CUDA); the cycles
    run in a thread of their own.  ``state`` (a fresh
    ``mock_server.MockState``) lets the caller read the server's store once
    the rig has ended."""
    import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
    import scheduler_tpu_torch.plugins  # noqa: F401
    from scheduler_tpu_torch.connector.client import connect_cache
    from scheduler_tpu_torch.connector.mock_server import serve
    from scheduler_tpu_torch.scheduler import Scheduler
    from scheduler_tpu_torch.utils.trigger import CycleTrigger

    import tempfile

    server, state = serve(0, state)
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    seed_cluster(state, cfg)

    # Outbound dialect: the batched legacy RPCs (one bulk-bind POST per
    # chunk, one batched event POST) — the churn scenario measures CYCLE
    # latency, and the k8s dialect's per-pod POST fanout through urllib's
    # one-connection-per-request transport measures the HTTP client
    # instead (a real deployment pools keep-alive connections; the mock
    # rig does not).  The INBOUND wire stays whatever SCHEDULER_TORCH_WIRE
    # says (k8s reflectors by default) — that is the protocol under test.
    cache, connector = connect_cache(base, dialect="legacy", wire=wire)
    stop = threading.Event()
    sched_thread = None
    conf_file = tempfile.NamedTemporaryFile(
        "w", suffix=".yaml", prefix="churn-conf-", delete=False
    )
    try:
        conf_file.write(CHURN_CONF)
        conf_file.close()
        cache.run()
        connector.start()
        if not connector.wait_for_cache_sync(timeout=60):
            raise RuntimeError("churn rig: cache never synced")

        trigger = CycleTrigger.from_env(default_max_interval=cfg.max_interval_s)
        sched = Scheduler(
            cache, scheduler_conf=conf_file.name,
            schedule_period=cfg.max_interval_s, device=device,
            trigger=trigger, record_cycles=True,
        )
        sched_thread = threading.Thread(
            target=sched.run, args=(stop,), daemon=True
        )
        sched_thread.start()

        # Warmup: replay slices build the engines for the task buckets
        # churn visits (the steady daemon builds once per (task-bucket,
        # lane-bucket) shape and re-runs; the measured window must not pay
        # the builds).  The rig then WAITS for the scheduler to drain the
        # warm traffic; evidence up to that point is discarded by
        # mark-index slicing — never by clearing the log, which would race
        # an in-flight warm cycle's append.
        if cfg.warm_s > 0:
            # Two slices: base rate first (the small task buckets steady
            # cycles live in), then burst rate (the large buckets the
            # measured window's bursts and coalesced batches reach).
            for wtag, wrate in (
                ("warma", cfg.rate),
                ("warmb", cfg.rate * max(2.0, cfg.burst_factor)),
            ):
                replay(state, make_history(
                    replace(cfg, duration_s=cfg.warm_s, rate=wrate),
                    tag=wtag,
                ))
                if not _wait_drained(sched, trigger, timeout=300.0):
                    raise RuntimeError(
                        "churn rig: scheduler never drained the warmup "
                        "traffic"
                    )
        mark = len(sched.cycle_log)
        # Counter snapshots at the measurement boundary: the artifact's
        # trigger/ingest blocks must describe the MEASURED window, not the
        # process lifetime — warmup-polluted totals would make two rounds
        # with different warm fractions look like ingest-volume changes.
        trigger_mark = (trigger.cycles, trigger.total_events)
        applied_mark = connector.events_applied
        # Keyed by instance, not kind: sharded pod ingestion (--watch-shards)
        # runs several reflectors of the SAME kind, and a kind-keyed mark
        # would subtract one shard's snapshot from every shard's counter.
        reflectors_mark = {
            id(r): (r.relists, r.relist_bytes)
            for r in getattr(connector, "reflectors", []) or []
        }

        history = make_history(cfg)
        rep = replay(state, history)
        # Drain the measured tail the same way, then stop the loop.
        drained = _wait_drained(sched, trigger, timeout=300.0)
        stop.set()
        sched_thread.join(timeout=60)
        cycles = list(sched.cycle_log)[mark:]
        if not drained:
            cycles = []  # cannot claim a latency distribution over a backlog
    finally:
        stop.set()
        # Teardown order matters: drain the cache's async IO against the
        # LIVE server first (bind chunks against a dead listener would each
        # eat a full client timeout), then stop ingestion, then the server.
        cache.stop()
        try:
            connector.stop()
        except Exception:
            pass
        server.shutdown()
        import os

        try:
            os.unlink(conf_file.name)
        except OSError:
            pass

    stats = _cycle_stats(cycles)
    reflectors = getattr(connector, "reflectors", None)
    from scheduler_tpu_torch.connector.reflector import watch_shards

    ingest = {
        "wire": type(connector).__name__,
        # Pod watch-stream shard count the run ingested under
        # (SCHEDULER_TORCH_WATCH_SHARDS / bench.py --churn --watch-shards):
        # the ROADMAP reflector-bottleneck slice compares churn artifacts
        # across this knob, so the artifact must say which regime it ran.
        "watch_shards": watch_shards(),
        # Measured-window delta (see the mark-time snapshot above).
        "events_applied": connector.events_applied - applied_mark,
    }
    if reflectors:
        # Window deltas again: relist_bytes accumulates the initial seed
        # LISTs too, which are boot cost, not churn cost.
        ingest["relists"] = sum(
            r.relists - reflectors_mark.get(id(r), (0, 0))[0]
            for r in reflectors
        )
        ingest["relist_bytes"] = sum(
            r.relist_bytes - reflectors_mark.get(id(r), (0, 0))[1]
            for r in reflectors
        )
    detail = {
        "family": "churn",
        "seed": cfg.seed,
        "nodes": cfg.nodes,
        "placed_pods": cfg.placed_pods,
        "pending_pods": cfg.pending_pods,
        "rate_target": cfg.rate,
        "rate_sustained": rep["rate"],
        "replay": rep,
        "duration_s": cfg.duration_s,
        "hit_rate_floor": hit_rate_floor,
        "trigger": {
            "debounce_ms": trigger.debounce * 1000.0,
            "min_ms": trigger.min_interval * 1000.0,
            "max_ms": trigger.max_interval * 1000.0,
            # Measured-window deltas, like ingest.events_applied.
            "cycles": trigger.cycles - trigger_mark[0],
            "events": trigger.total_events - trigger_mark[1],
        },
        "ingest": ingest,
        # Per-cycle tail capped: a 10-minute soak must not emit megabytes.
        "cycles": [
            {
                "s": round(c["s"], 4),
                "t": round(c["t"], 3),
                "events": c["events"],
                "engine_cache": c["notes"].get("engine_cache", "?"),
                "dirty": c["notes"].get("dirty", {}),
                "gc": c.get("gc", False),
            }
            for c in cycles[-500:]
        ],
    }
    detail.update(stats)
    return {
        "metric": "churn_p99_cycle_ms",
        "value": detail["p99_ms"],
        "unit": "ms",
        # The ROADMAP target: p99 < 100ms at the configured rate.
        "vs_target": round(detail["p99_ms"] / 100.0, 4),
        "detail": detail,
    }
