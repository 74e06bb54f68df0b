"""Fake side-effect interfaces for cluster-free testing
(reference ``pkg/scheduler/util/test_utils.go:95-163``).

FakeBinder/FakeEvictor record intents into lists + a queue.Queue "channel" so
tests can wait on them with a timeout, exactly like the reference's Go channels.
"""

from __future__ import annotations

import queue
import threading
from typing import List

from scheduler_tpu_torch.cache.interface import Binder, Evictor, StatusUpdater, VolumeBinder


class FakeBinder(Binder):
    """Records bind intents.  Columnar-aware: ``bind_rows`` batches are stored
    by REFERENCE and the ``ns/name`` key strings only materialize when the
    ``binds`` dict is actually read — key construction for a 100k-bind batch
    is test/inspection cost, not commit-path cost."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self._cond = threading.Condition(self.lock)
        self._folded: dict = {}
        self._keys: List[str] = []  # bind-order key log (drives wait())
        self._times: List[float] = []  # monotonic record time per key
        self._batches: list = []  # deferred (pods, hostnames, t) batches
        self._count = 0
        self._served = 0

    def _fold_locked(self) -> None:
        for pods, hostnames, t in self._batches:
            folded = self._folded
            append = self._keys.append
            tappend = self._times.append
            for pod, hostname in zip(pods, hostnames):
                key = f"{pod.namespace}/{pod.name}"
                folded[key] = hostname
                append(key)
                tappend(t)
        self._batches.clear()

    @property
    def binds(self) -> dict:
        with self.lock:
            self._fold_locked()
            return self._folded

    def bind(self, pod, hostname: str) -> None:
        import time as _time

        with self._cond:
            self._fold_locked()
            key = f"{pod.namespace}/{pod.name}"
            self._folded[key] = hostname
            self._keys.append(key)
            self._times.append(_time.monotonic())
            self._count += 1
            self._cond.notify_all()

    def bind_bulk(self, pairs) -> None:
        self.bind_rows([p for p, _ in pairs], [h for _, h in pairs])

    def bind_rows(self, pods, hostnames) -> None:
        import time as _time

        with self._cond:
            self._batches.append((pods, hostnames, _time.monotonic()))
            self._count += len(hostnames)
            self._cond.notify_all()

    def bind_records(self):
        """[(key, hostname, monotonic_time)] in bind order — the per-pod
        latency join the benchmark harness consumes (the reference's
        benchmark joins scheduler events with pod timestamps the same way,
        test/e2e/benchmark.go:262-282)."""
        with self.lock:
            self._fold_locked()
            return [
                (k, self._folded[k], t)
                for k, t in zip(self._keys, self._times)
            ]

    def wait(self, n: int, timeout: float = 3.0) -> List[str]:
        """Block until n more binds were recorded (or raise queue.Empty).
        Concurrent waiters RESERVE disjoint key ranges up front (the channel
        pop they replace was atomic per key)."""
        with self._cond:
            start = self._served
            self._served = target = start + n
            if not self._cond.wait_for(lambda: self._count >= target, timeout=timeout):
                if self._served == target:
                    # Un-reserve only when no later waiter reserved past us —
                    # rolling back under one would hand out overlapping keys.
                    self._served = start
                raise queue.Empty
            self._fold_locked()
            return self._keys[start:target]


class FakeEvictor(Evictor):
    """Records evict intents; like FakeBinder, the ``ns/name`` key strings
    fold lazily — the per-evict commit path only appends a pod ref."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self._cond = threading.Condition(self.lock)
        self._pods: List = []
        self._keys: List[str] = []
        self._served = 0

    def _fold_locked(self) -> None:
        if len(self._keys) < len(self._pods):
            for pod in self._pods[len(self._keys):]:
                self._keys.append(f"{pod.namespace}/{pod.name}")

    @property
    def evicts(self) -> List[str]:
        with self.lock:
            self._fold_locked()
            return self._keys

    def evict(self, pod) -> None:
        with self._cond:
            self._pods.append(pod)
            self._cond.notify_all()

    def wait(self, n: int, timeout: float = 3.0) -> List[str]:
        with self._cond:
            start = self._served
            self._served = target = start + n
            if not self._cond.wait_for(
                lambda: len(self._pods) >= target, timeout=timeout
            ):
                if self._served == target:
                    self._served = start
                raise queue.Empty
            self._fold_locked()
            return self._keys[start:target]


class FakeStatusUpdater(StatusUpdater):
    def __init__(self, record_events: bool = False) -> None:
        self.pod_conditions: List = []
        self.pod_group_updates: List = []
        self.events: List = []
        # Opt-in: the synthetic benchmarks run with the default fake, and
        # event-payload construction must stay off their commit path.
        self.RECORDS_EVENTS = record_events

    def update_pod_condition(self, pod, condition) -> None:
        self.pod_conditions.append((pod, condition))

    def update_pod_group(self, job) -> None:
        self.pod_group_updates.append(job)

    def record_events(self, events: list) -> None:
        self.events.extend(events)


class FakeVolumeBinder(VolumeBinder):
    # No side effects at all: the columnar commit path skips task-view
    # materialization entirely for NOOP volume binders.
    NOOP = True

    def allocate_volumes(self, task, hostname: str) -> None:
        pass

    def bind_volumes(self, task) -> None:
        pass
