"""Preempt-storm scenario, seeding half (``scheduler_tpu/harness/preempt_storm.py``):
priority storms and SLA-tiered arrivals over a SATURATED cluster.

A high-priority arrival only schedules by evicting someone.  The pieces:

* ``make_storm(cfg)`` — a deterministic SLA-tiered arrival history from a
  seed (exponential inter-arrivals, per-tier priorities and request sizes);
* ``seed_saturated_cache(cfg)`` — the full cluster straight into a
  ``SchedulerCache``: filler gangs of Running pods pinned node-round-robin,
  consuming every node's CPU, with ``min_member`` floors high enough that
  the live gang floor is load-bearing;
* ``add_storm(cache, cfg)`` — the storm's arrivals as pending pods.

The JAX package's bench rig (``run_preempt_bench``: the mock apiserver, the
watch wire and the event-triggered scheduler) needs the daemon, which the
port does not carry yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MIB = 1024.0 * 1024.0
GIB = 1024.0 * MIB

@dataclass
class ChurnEvent:
    """One history event (``scheduler_tpu/harness/churn.py::ChurnEvent``)."""

    t: float      # seconds from history start
    kind: str     # "pod"
    op: str       # add | delete
    obj: dict = field(default_factory=dict)


# Scheduling conf for the storm rig: priority ordering + the
# conformance/gang victim dispatch, preempt after allocate the way the
# reference orders its cycle.  Deliberately NO drf victim fn: drf vetoes
# any eviction that would push the preemptor's dominant share past the
# victim's, which caps a sustained priority storm at share parity after a
# handful of binds — the scenario exists to measure PRIORITY preemption
# throughput against the gang floor, and the drf mask keeps its own
# coverage in tests/test_evict_parity.py.  Victims still evict
# cheapest-first (reverse builtin task order), so storms drain priority-0
# filler before ever touching each other.
PREEMPT_CONF = """
actions: "allocate, preempt"
tiers:
- plugins:
  - name: priority
  - name: conformance
  - name: gang
  - name: binpack
"""

# SLA tiers: (name, pod priority, share of the storm).  Deadline jobs are
# the gold tier — the artifact splits time-to-preempt per tier so an SLA
# inversion (bronze beating gold) is visible in the numbers.
SLA_TIERS: Tuple[Tuple[str, int, float], ...] = (
    ("gold", 100, 0.2),
    ("silver", 50, 0.3),
    ("bronze", 10, 0.5),
)


@dataclass
class PreemptStormConfig:
    seed: int = 0
    nodes: int = 32
    fill_per_node: int = 8         # Running filler pods per node (saturation)
    filler_gang: int = 8           # tasks per filler PodGroup
    filler_min_member: int = 4     # gang floor: at most gang-min evictable
    storm_pods: int = 96           # measured high-priority arrivals
    rate: float = 60.0             # storm arrival rate, events/s
    warm_pods: int = 12            # the bench rig's warm-up arrivals
    node_cpu_milli: float = 8000.0
    node_memory: float = 32.0 * GIB
    drain_timeout_s: float = 300.0
    max_interval_s: float = 0.25   # quiet-cluster rescan clamp
    namespace: str = "default"
    tiers: Tuple[Tuple[str, int, float], ...] = field(default=SLA_TIERS)

    @property
    def placed_pods(self) -> int:
        return self.nodes * self.fill_per_node

    @property
    def duration_s(self) -> float:
        return self.storm_pods / max(self.rate, 1e-9)


def _filler_request(cfg: PreemptStormConfig) -> Dict[str, float]:
    """Every filler pod takes an equal CPU slice, so ``fill_per_node`` of
    them exactly saturate a node — arrivals MUST evict to place."""
    return {
        "cpu": cfg.node_cpu_milli / cfg.fill_per_node,
        "memory": 256.0 * MIB,
    }


def _storm_request(cfg: PreemptStormConfig, i: int) -> Dict[str, float]:
    """Storm requests sized in filler slices: mostly one victim suffices,
    every 4th arrival needs two — multi-victim sufficiency prefixes stay
    exercised."""
    slices = 2 if i % 4 == 3 else 1
    return {
        "cpu": (cfg.node_cpu_milli / cfg.fill_per_node) * slices,
        "memory": 128.0 * MIB,
    }


def _tier_of(cfg: PreemptStormConfig, u: float) -> Tuple[str, int]:
    """Map a uniform draw to an SLA tier (name, priority)."""
    acc = 0.0
    for name, prio, share in cfg.tiers:
        acc += share
        if u <= acc:
            return name, prio
    name, prio, _ = cfg.tiers[-1]
    return name, prio


def make_storm(cfg: PreemptStormConfig, tag: str = "storm",
               count: Optional[int] = None) -> List[ChurnEvent]:
    """The seeded storm history: ``count`` (default ``cfg.storm_pods``)
    SLA-tiered high-priority pod arrivals with exponential inter-arrivals at
    ``cfg.rate``.  A pure function of (cfg, tag) — parity replays and the
    warmup slice coexist in one server store via the tag namespace."""
    rng = np.random.default_rng(cfg.seed if tag == "storm" else cfg.seed + 977)
    n = cfg.storm_pods if count is None else count
    events: List[ChurnEvent] = []
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(1.0 / max(cfg.rate, 1e-9)))
        tier, prio = _tier_of(cfg, float(rng.uniform()))
        name = f"{tag}-{i:05d}"
        events.append(ChurnEvent(t, "pod", "add", {
            "name": name, "namespace": cfg.namespace,
            "uid": f"{cfg.namespace}/{name}",
            "group": f"sla-{tier}",
            "containers": [_storm_request(cfg, i)],
            "phase": "Pending",
            "priority": prio,
            # Deadline jobs: the SLA tier rides an annotation.
            "annotations": {"scheduler-tpu/sla-tier": tier},
        }))
    return events


def _seed_objects(cfg: PreemptStormConfig) -> Dict[str, Dict[str, dict]]:
    """The saturated cluster as wire-shaped objects, shared by the server
    seeding and the cache seeding so the two can never drift."""
    ns = cfg.namespace
    objects: Dict[str, Dict[str, dict]] = {
        "queue": {}, "node": {}, "podgroup": {}, "pod": {},
    }
    objects["queue"]["default"] = {"name": "default", "weight": 1}
    for i in range(cfg.nodes):
        name = f"pn-{i:05d}"
        objects["node"][name] = {
            "name": name,
            "allocatable": {
                "cpu": cfg.node_cpu_milli,
                "memory": cfg.node_memory,
                "pods": 110,
            },
        }
    # Filler gangs: Running pods pinned round-robin across the node set,
    # exactly saturating every node's CPU.  min_member > 1 keeps the gang
    # floor load-bearing — a hunt may take at most
    # (gang - min_member) victims from one cohort.
    total = cfg.placed_pods
    n_gangs = max(1, -(-total // cfg.filler_gang))
    idx = 0
    for g in range(n_gangs):
        size = min(cfg.filler_gang, total - g * cfg.filler_gang)
        if size <= 0:
            break
        group = f"fill-{g:04d}"
        objects["podgroup"][f"{ns}/{group}"] = {
            "name": group, "namespace": ns, "queue": "default",
            "minMember": min(cfg.filler_min_member, size), "phase": "Running",
        }
        for k in range(size):
            name = f"{group}-{k:04d}"
            objects["pod"][f"{ns}/{name}"] = {
                "name": name, "namespace": ns, "uid": f"{ns}/{name}",
                "group": group,
                "containers": [_filler_request(cfg)],
                "phase": "Running",
                "nodeName": f"pn-{idx % cfg.nodes:05d}",
                "priority": 0,
            }
            idx += 1
    # SLA lanes: one min_member=1 PodGroup per tier — storm arrivals join
    # their tier's lane (the churn-lane shape: arrivals under PodGroups,
    # every member schedules independently).
    for tier, _, _ in cfg.tiers:
        lane = f"sla-{tier}"
        objects["podgroup"][f"{ns}/{lane}"] = {
            "name": lane, "namespace": ns, "queue": "default",
            "minMember": 1, "phase": "Inqueue",
        }
    return objects


def seed_saturated_cache(cfg: PreemptStormConfig, vocab=None):
    """The saturated cluster straight into a SchedulerCache (no wire),
    through the wire parsers (``connector/wire.py``)."""
    from scheduler_tpu_torch.cache.cache import SchedulerCache
    from scheduler_tpu_torch.connector.wire import (
        parse_node, parse_pod, parse_pod_group, parse_queue,
    )

    objects = _seed_objects(cfg)
    cache = SchedulerCache(vocab=vocab, async_io=False)
    for q in objects["queue"].values():
        cache.add_queue(parse_queue(q))
    for n in objects["node"].values():
        cache.add_node(parse_node(n))
    for g in objects["podgroup"].values():
        cache.add_pod_group(parse_pod_group(g))
    for p in objects["pod"].values():
        cache.add_pod(parse_pod(p, cache.scheduler_name))
    return cache


def add_storm(cache, cfg: PreemptStormConfig, tag: str = "storm",
              count: Optional[int] = None) -> int:
    """Add ``make_storm(cfg, tag, count)``'s arrivals to ``cache`` as
    pending pods (through ``connector/wire.py::parse_pod``), in arrival
    order; returns how many."""
    from scheduler_tpu_torch.connector.wire import parse_pod

    events = make_storm(cfg, tag, count)
    for ev in events:
        cache.add_pod(parse_pod(ev.obj, cache.scheduler_name))
    return len(events)
