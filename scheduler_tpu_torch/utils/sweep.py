"""Memoized node sweeps for preempt/reclaim (``scheduler_tpu/utils/sweep.py``).

The reference runs a full PredicateNodes + PrioritizeNodes + SortNodes sweep
per preemptor task (preempt.go:191-195, 16-way parallel); at BASELINE
scenario 4 scale (50k pending tasks x 10k nodes) that is O(T x N) Python
here.  Two observations make the sweep O(1) per task instead:

* **Predicate results are per-signature.**  For tasks without scan-dynamic
  predicates (host ports, inter-pod affinity), the predicate outcome depends
  only on (request row, node selector, required node affinity, tolerations)
  x node — and the node-side inputs (labels, taints, readiness, pressure)
  never change during an action.  The only live predicate component, the
  pod-count limit, is re-checked per candidate at iteration time
  (``node_open``).
* **Scores are frozen during preempt/reclaim.**  The builtin scorers
  (least-requested / balanced / binpack / static node-affinity preferences)
  read node ``idle`` and ``allocatable`` only.  Preemption never touches
  idle: evictions move resources used -> releasing, and pipelining consumes
  releasing — so one sweep per signature is exact for the whole action.

``SweepCache.enabled`` gates on exactly those builtins (every predicate
plugin registered a static variant; scoring only from "nodeorder" or
"binpack"); anything else falls back to the reference's per-task sweep.
The same ``static_predicate_sig`` lets backfill's sweep start past a node
prefix proven to fail (``actions/backfill.py``).

Candidate-presence gating (which nodes still hold viable victims) lives in
``ops/victims.py`` (VictimGate).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.utils.scheduler_helper import (
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    sort_nodes,
)


def static_predicate_sig(task: TaskInfo) -> Optional[tuple]:
    """Signature of everything the static predicates read from a task, or
    None when the task carries a scan-dynamic predicate (host ports,
    inter-pod (anti-)affinity) and needs the exact per-task sweep."""
    pod = task.pod
    if pod is None:
        return None
    aff = pod.affinity
    if pod.host_ports or (aff and (aff.pod_affinity or aff.pod_anti_affinity)):
        return None
    return (
        repr(sorted(pod.node_selector.items())),
        repr(pod.tolerations),
        repr(aff.node_required) if aff else "",
        repr(getattr(aff, "node_preferred", None)) if aff else "",
    )


class SweepCache:
    """sig -> best-first node list, memoized for one action execution."""

    def __init__(self, ssn) -> None:
        self.ssn = ssn
        self._cache: Dict[tuple, List[NodeInfo]] = {}
        self._node_list: Optional[List[NodeInfo]] = None  # lazy: hunts only

        scoring = set(ssn.node_order_fns) | set(ssn.node_map_fns)
        self.enabled = (
            set(ssn.predicate_fns) <= set(ssn.static_predicate_fns)
            # Builtin scorers read only node idle/allocatable/labels — all
            # frozen during preempt/reclaim.  Batch scorers (inter-pod
            # affinity preferences) depend on live placements: no caching.
            and scoring <= {"nodeorder", "binpack"}
            and not ssn.batch_node_order_fns
        )
        # The pod-count live gate applies exactly when the predicates plugin's
        # predicate would run in the dispatch (registered AND tier-enabled).
        self._check_pod_count = "predicates" in ssn.predicate_fns and any(
            plugin.name == "predicates" and plugin.predicate_enabled()
            for tier in ssn.tiers
            for plugin in tier.plugins
        )

    def task_sig(self, task: TaskInfo) -> Optional[tuple]:
        """Everything the cached sweep depends on; None -> task needs the
        exact per-task path (scan-dynamic predicates)."""
        sig = static_predicate_sig(task)
        if sig is None:
            return None
        return (task.req_sig,) + sig

    def ordered_nodes(self, task: TaskInfo) -> Optional[List[NodeInfo]]:
        """Best-first candidate nodes for this task, memoized by signature.
        Returns None when the task (or session) needs the legacy sweep.
        Callers must still apply the live pod-count gate (``node_open``)."""
        if not self.enabled:
            return None
        sig = self.task_sig(task)
        if sig is None:
            return None
        hit = self._cache.get(sig)
        if hit is None:
            hit = full_sweep(self.ssn, task, self.ssn.static_predicate_fn)
            self._cache[sig] = hit
        return hit

    def passing_nodes(self, task: TaskInfo) -> Optional[List[NodeInfo]]:
        """Name-ordered nodes passing the static predicate, memoized by
        signature — reclaim's shape (no scoring: the reference walks the node
        map and takes the first workable node, reclaim.go:134-141)."""
        if not self.enabled:
            return None
        sig = self.task_sig(task)
        if sig is None:
            return None
        key = ("passing",) + sig
        hit = self._cache.get(key)
        if hit is None:
            if self._node_list is None:
                self._node_list = get_node_list(self.ssn.nodes)
            hit, _ = predicate_nodes(task, self._node_list, self.ssn.static_predicate_fn)
            self._cache[key] = hit
        return hit

    def node_open(self, node: NodeInfo) -> bool:
        """The live predicate component: pod-count headroom (the cached sweep
        used the static predicate, which excludes it by contract)."""
        if not self._check_pod_count:
            return True
        return len(node.tasks) < node.pods_limit


def full_sweep(ssn, task: TaskInfo, predicate) -> List[NodeInfo]:
    """The reference's per-task pipeline (preempt.go:191-195): predicate all
    nodes, score the passing set, best-first.  One definition shared by the
    memoized path (static predicate) and the legacy fallback (full
    predicate) so the two cannot drift."""
    passing, _ = predicate_nodes(task, get_node_list(ssn.nodes), predicate)
    scores = prioritize_nodes(
        task,
        passing,
        ssn.batch_node_order_fn,
        ssn.node_order_map_fn,
        ssn.node_order_reduce_fn,
    )
    return sort_nodes(scores)
