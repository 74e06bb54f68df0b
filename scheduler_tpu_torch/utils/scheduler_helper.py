"""Host-path scheduling helpers (reference ``pkg/scheduler/util/scheduler_helper.go``).

These back the *fallback* path used when a session carries plugins without
device counterparts; the accelerated path lives in ``scheduler_tpu_torch.ops``.  The
reference parallelizes these sweeps across 16 goroutines; under the GIL plain
loops are faster for the fallback's scale, so the fan-out stays in the device
engine where it belongs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.unschedule_info import FitErrors


def get_node_list(nodes: Dict[str, NodeInfo]) -> List[NodeInfo]:
    return sorted(nodes.values(), key=lambda n: n.name)


def predicate_nodes(
    task: TaskInfo,
    nodes: List[NodeInfo],
    fn: Callable[[TaskInfo, NodeInfo], None],
) -> Tuple[List[NodeInfo], FitErrors]:
    """All nodes passing ``fn`` (which raises on failure), plus the failures
    (scheduler_helper.go:34-64)."""
    passing: List[NodeInfo] = []
    errors = FitErrors()
    for node in nodes:
        try:
            fn(task, node)
        except Exception as err:  # FitError or plugin-raised failure
            errors.set_node_error(node.name, err)
        else:
            passing.append(node)
    return passing, errors


def prioritize_nodes(
    task: TaskInfo,
    nodes: List[NodeInfo],
    batch_fn: Callable,
    map_fn: Callable,
    reduce_fn: Callable,
) -> Dict[NodeInfo, float]:
    """Map/reduce + batch scoring merge (scheduler_helper.go:67-129)."""
    plugin_scores: Dict[str, Dict[str, float]] = {}
    order_scores: Dict[NodeInfo, float] = {}
    for node in nodes:
        per_plugin, score = map_fn(task, node)
        order_scores[node] = score
        for plugin, s in per_plugin.items():
            plugin_scores.setdefault(plugin, {})[node.name] = s

    reduced = reduce_fn(task, plugin_scores)
    batch = batch_fn(task, nodes)

    result: Dict[NodeInfo, float] = {}
    for node in nodes:
        result[node] = (
            order_scores.get(node, 0.0)
            + reduced.get(node.name, 0.0)
            + batch.get(node.name, 0.0)
        )
    return result


def select_best_node(node_scores: Dict[NodeInfo, float]) -> NodeInfo:
    """Lowest-name pick among the top-scoring nodes.

    The reference picks uniformly at random among ties
    (scheduler_helper.go:147-158); we deliberately pick the first node in name
    order instead — same top-score class, but deterministic, which makes
    scheduling decisions reproducible and lets the host engine be
    property-tested bind-for-bind against the device engines (which take the
    lowest node index, i.e. the same name-ordered choice)."""
    best_score = None
    best: Optional[NodeInfo] = None
    for node, score in node_scores.items():
        if (
            best_score is None
            or score > best_score
            or (score == best_score and best is not None and node.name < best.name)
        ):
            best_score = score
            best = node
    assert best is not None
    return best


def enabled_task_order_chain(ssn) -> set:
    """Plugin names whose task-order callbacks are registered AND enabled, in
    dispatch terms — THE single source for every consumer that special-cases
    the builtin chain (task_sort_key's fast path, the columnar engines)."""
    return {
        plugin.name
        for tier in ssn.tiers
        for plugin in tier.plugins
        if plugin.task_order_enabled() and plugin.name in ssn.task_order_fns
    }


def task_order_builtin(ssn) -> bool:
    """True when the enabled task-order chain is the builtin priority plugin
    (or empty) — i.e. the sort key is the plain ``(-priority, req_sig,
    creation, uid)`` tuple, which the columnar engines build straight from the
    job store columns without materializing task objects."""
    return enabled_task_order_chain(ssn) <= {"priority"}


def task_sort_key(ssn) -> Callable:
    """Sort key equivalent of the session's task_order_fn for list.sort().

    Fast path: when the enabled task-order chain is the builtin priority
    plugin (or empty), the comparator chain collapses to a plain tuple key —
    list.sort() then runs entirely in C instead of dispatching a Python
    comparator through every tier per comparison (~500k dispatches for a
    100k-task cycle, the dominant host-side cost before this path existed).
    """
    enabled = enabled_task_order_chain(ssn)
    if enabled <= {"priority"}:
        if "priority" in enabled:
            # priority.go:39-59: higher pod priority first; then the same
            # deterministic tie-break chain as the generic path below.
            def key(t: TaskInfo):
                return (-t.priority, t.req_sig, t.creation_timestamp, t.uid)
        else:
            def key(t: TaskInfo):
                return (t.req_sig, t.creation_timestamp, t.uid)
        return key

    def cmp(l: TaskInfo, r: TaskInfo) -> int:
        res = ssn.task_compare_fns(l, r)
        if res != 0:
            return res
        # Deterministic tie-break among plugin-equal tasks.  The reference's
        # heap breaks such ties arbitrarily (util/priority_queue.go), so any
        # total order is within spec; grouping identical requests first lets
        # the device engine batch whole runs per placement step.
        if l.req_sig != r.req_sig:
            return -1 if l.req_sig < r.req_sig else 1
        if l.creation_timestamp != r.creation_timestamp:
            return -1 if l.creation_timestamp < r.creation_timestamp else 1
        return -1 if l.uid < r.uid else (1 if l.uid > r.uid else 0)

    return functools.cmp_to_key(cmp)
