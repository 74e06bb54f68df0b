"""Cluster-state loading (the preload half of the JAX package's ``cli.py``;
the daemon, its HTTP endpoints and the connector are not part of this
package)."""

from __future__ import annotations

import json

from scheduler_tpu_torch.cache.cache import SchedulerCache


def load_cluster_state(cache: SchedulerCache, path: str) -> None:
    """Preload cluster state from a JSON file: {queues, nodes, podGroups, pods}
    — the same object schema the JAX package's ``--cluster-state`` reads."""
    from scheduler_tpu_torch.harness.wire import (
        parse_node,
        parse_pod,
        parse_pod_group,
        parse_queue,
    )

    with open(path, "r") as f:
        state = json.load(f)
    for q in state.get("queues", []):
        cache.add_queue(parse_queue(q))
    for n in state.get("nodes", []):
        cache.add_node(parse_node(n))
    for g in state.get("podGroups", []):
        cache.add_pod_group(parse_pod_group(g))
    for p in state.get("pods", []):
        cache.add_pod(parse_pod(p, cache.scheduler_name))
