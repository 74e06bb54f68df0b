"""Unschedulable-reason bookkeeping (reference ``pkg/scheduler/api/unschedule_info.go``).

FitErrors aggregates per-node failure reasons for one task into the histogram-style
message the reference emits ("3 node(s) resource fit failed, ...").
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

ALL_NODE_UNAVAILABLE = "all nodes are unavailable"
NODE_RESOURCE_FIT_FAILED = "node(s) resource fit failed"
NODE_POD_NUMBER_EXCEEDED = "node(s) pod number exceeded"


class FitError(Exception):
    """Why one task does not fit one node."""

    def __init__(self, task_name: str = "", node_name: str = "", *reasons: str) -> None:
        self.task_name = task_name
        self.node_name = node_name
        self.reasons = tuple(reasons) if reasons else (ALL_NODE_UNAVAILABLE,)
        super().__init__(self.error())

    def error(self) -> str:
        return "task {} on node {} fit failed: {}".format(
            self.task_name, self.node_name, ", ".join(self.reasons)
        )


class FitErrors:
    """Per-task aggregation of node fit errors (``unschedule_info.go:22-79``).

    ``error()`` emits the reference's exact format: ``"<err>: <histogram>."`` where
    err defaults to "all nodes are unavailable" and the histogram is the
    lexicographically sorted join of ``"<count> <reason>"`` strings.
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, FitError] = {}
        self._err: Optional[str] = None

    def set_node_error(self, node_name: str, err: Exception) -> None:
        fe = err if isinstance(err, FitError) else FitError("", node_name, str(err))
        fe.node_name = node_name
        self.nodes[node_name] = fe

    def set_error(self, msg: str) -> None:
        self._err = msg

    def error(self) -> str:
        reasons: Counter = Counter()
        for fe in self.nodes.values():
            for reason in fe.reasons:
                reasons[reason] += 1
        histogram = ", ".join(sorted(f"{cnt} {r}" for r, cnt in reasons.items()))
        err = self._err if self._err is not None else ALL_NODE_UNAVAILABLE
        return f"{err}: {histogram}."
