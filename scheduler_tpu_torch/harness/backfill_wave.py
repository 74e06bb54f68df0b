"""Backfill-wave scenario, seeding half (``scheduler_tpu/harness/backfill_wave.py``):
a BestEffort pod wave over a pod-count-saturated cluster.

BestEffort pods carry an EMPTY resource request, so the only capacities in
play are the static predicates and each node's pod-count room.  The hard
case is the oversized wave: far more BestEffort pods than the cluster has
pod slots, so after the placeable head binds, the host sweep pays
O(tail x nodes) predicate calls proving the tail unplaceable; the device
flavor (``SCHEDULER_TORCH_BACKFILL=device``, ``ops/backfill.py``) folds it
into class masks and a batched water-fill.  The pieces:

* ``seed_wave_cache(cfg)`` — the saturated cluster and the wave straight
  into a ``SchedulerCache``;
* ``_bind_digest`` — an order-free digest of a run's binds.

The JAX package's bench rig (``run_backfill_bench``: the mock apiserver,
the watch wire and the event-triggered scheduler) needs the daemon, which
the port does not carry yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

GIB = 1024.0 * 1024.0 * 1024.0

# Scheduling conf for the wave rig: backfill only, predicates enabled — the
# wave is ALL BestEffort, so allocate would walk the job list and skip every
# task (actions/allocate.py leaves empty requests to backfill).  Predicates
# supply the node_selector mask AND the pod-count gate (ops/predicates.py);
# without the plugin the host sweep enforces nothing and the scenario
# collapses to a trivial first-node fill.
BACKFILL_CONF = """
actions: "backfill"
tiers:
- plugins:
  - name: predicates
"""

# Node zones: labels partition the cluster, zone-pinned wave pods carry a
# matching node_selector — the class mask is non-trivial (one signature
# class per selector flavor x queue) without inflating the class count past
# what a real BestEffort filler fleet looks like.
ZONES = ("za", "zb", "zc", "zd")


@dataclass
class BackfillWaveConfig:
    seed: int = 0
    nodes: int = 2048
    wave_pods: int = 20000         # BestEffort arrivals (the measured wave)
    fill_per_node: int = 14        # Running pods per node pre-wave
    pods_limit: int = 22           # node pod capacity: room = limit - fill
    selector_every: int = 3        # every k-th wave pod is zone-pinned
    measure_cycles: int = 2        # steady-state tail re-sweeps to sample
    drain_timeout_s: float = 900.0
    max_interval_s: float = 0.25   # quiet-cluster rescan clamp
    namespace: str = "default"

    @property
    def room_per_node(self) -> int:
        return max(self.pods_limit - self.fill_per_node, 0)

    @property
    def capacity(self) -> int:
        """Pod-count slots the wave can fill (selectors may strand some)."""
        return self.nodes * self.room_per_node


def _seed_objects(cfg: BackfillWaveConfig) -> Dict[str, Dict[str, dict]]:
    """The saturated cluster plus the wave as wire-shaped objects, shared by
    the server seeding and the cache seeding so the two can never drift."""
    import numpy as np

    ns = cfg.namespace
    objects: Dict[str, Dict[str, dict]] = {
        "queue": {}, "node": {}, "podgroup": {}, "pod": {},
    }
    objects["queue"]["default"] = {"name": "default", "weight": 1}
    for i in range(cfg.nodes):
        name = f"bn-{i:05d}"
        objects["node"][name] = {
            "name": name,
            "labels": {"zone": ZONES[i % len(ZONES)]},
            "allocatable": {
                "cpu": 8000.0,
                "memory": 32.0 * GIB,
                "pods": cfg.pods_limit,
            },
        }
    # Pre-wave occupancy: Running pods pinned round-robin, eating
    # ``fill_per_node`` of every node's pod count.  They carry a real CPU
    # request — backfill ignores them either way; what matters is
    # ``len(node.tasks)`` against the pod limit (the monotone room gate).
    group = "occupied"
    objects["podgroup"][f"{ns}/{group}"] = {
        "name": group, "namespace": ns, "queue": "default",
        "minMember": 1, "phase": "Running",
    }
    total = cfg.nodes * cfg.fill_per_node
    for k in range(total):
        name = f"{group}-{k:06d}"
        objects["pod"][f"{ns}/{name}"] = {
            "name": name, "namespace": ns, "uid": f"{ns}/{name}",
            "group": group,
            "containers": [{"cpu": 100.0, "memory": 0.25 * GIB}],
            "phase": "Running",
            "nodeName": f"bn-{k % cfg.nodes:05d}",
        }
    # The BestEffort wave: EMPTY containers -> empty resource request, the
    # population actions/backfill.py owns.  Zone pins rotate through a
    # seeded permutation so consecutive wave pods interleave signature
    # classes — the device engine's run segmentation earns its keep.
    lane = "wave"
    objects["podgroup"][f"{ns}/{lane}"] = {
        "name": lane, "namespace": ns, "queue": "default",
        "minMember": 1, "phase": "Inqueue",
    }
    rng = np.random.default_rng(cfg.seed)
    zone_of = rng.integers(0, len(ZONES), size=cfg.wave_pods)
    for p in range(cfg.wave_pods):
        name = f"wave-{p:06d}"
        pod = {
            "name": name, "namespace": ns, "uid": f"{ns}/{name}",
            "group": lane,
            "containers": [],
            "phase": "Pending",
        }
        if cfg.selector_every > 0 and p % cfg.selector_every == 0:
            pod["nodeSelector"] = {"zone": ZONES[int(zone_of[p])]}
        objects["pod"][f"{ns}/{name}"] = pod
    return objects


def seed_wave_cache(cfg: BackfillWaveConfig, vocab=None):
    """The cluster and the wave straight into a SchedulerCache (no wire),
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


def _bind_digest(binds: List[dict]) -> str:
    """Order-free digest of the (pod -> node) outcome: ``binds`` is a list
    of ``{"pod", "node"}`` records."""
    import hashlib

    lines = sorted(f"{b['pod']}={b['node']}" for b in binds)
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()
