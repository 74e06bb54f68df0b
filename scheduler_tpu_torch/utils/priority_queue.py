"""Heap-backed priority queue over a caller-supplied less-function
(reference ``pkg/scheduler/util/priority_queue.go``).

The less-fn returns True when ``l`` should pop before ``r`` — the same contract as
the Session's QueueOrderFn/JobOrderFn/TaskOrderFn comparators.  Insertion order
breaks ties stably so repeated sessions are deterministic.
"""

from __future__ import annotations

import heapq
import functools
import itertools
from typing import Any, Callable


class PriorityQueue:
    __slots__ = ("_heap", "_less", "_counter", "_keyed")

    def __init__(self, less_fn: Callable[[Any, Any], bool]) -> None:
        self._less = less_fn
        self._heap: list = []
        self._counter = itertools.count()

        less = less_fn

        @functools.total_ordering
        class _Entry:
            __slots__ = ("item", "seq")

            def __init__(self, item: Any, seq: int) -> None:
                self.item = item
                self.seq = seq

            def __lt__(self, other: "_Entry") -> bool:
                if less(self.item, other.item):
                    return True
                if less(other.item, self.item):
                    return False
                return self.seq < other.seq

            def __eq__(self, other: object) -> bool:
                return self is other

        self._keyed = _Entry

    def push(self, item: Any) -> None:
        heapq.heappush(self._heap, self._keyed(item, next(self._counter)))

    def pop(self) -> Any:
        return heapq.heappop(self._heap).item

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
