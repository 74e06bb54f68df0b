"""Event-triggered cycle pacing: the seam between ingestion and scheduling.

The scheduler loop historically ran cold fixed-cadence cycles
(``wait.Until(runOnce, period)``, scheduler.go:85) — a 1s tick against a
cluster whose state arrives as a continuous watch stream.  Production
traffic is sustained watch-event churn (pods arriving and dying at
1-10k events/s against a mostly-placed cluster), and a fixed tick either
wastes cycles on a quiet cluster or adds up to a full period of placement
latency under load.  ``CycleTrigger`` converts the connector's ``_apply``
seam (shared by the journal and k8s wires, ``connector/client.py``) into a
cycle pacemaker:

* every applied watch event calls ``notify()`` (one counter bump + event
  set — cheap enough for the watch threads at 10k events/s);
* the scheduler loop blocks in ``wait()`` until a cycle should fire, with

  - a **debounce window** (``SCHEDULER_TORCH_DEBOUNCE_MS``): the window opens
    at the FIRST event observed and closes after the fixed debounce — a
    storm cannot slide it forward, so a sustained burst can never starve
    binding (events keep coalescing into the next batch instead);
  - a **min-interval clamp** (``SCHEDULER_TORCH_TRIGGER_MIN_MS``): cycle
    starts are at least this far apart, so an event storm cannot spin the
    loop faster than cycles are worth running;
  - a **max-interval clamp** (``SCHEDULER_TORCH_TRIGGER_MAX_MS``, defaulting
    to the configured schedule period): a quiet cluster still rescans —
    the drift-healing full pass the reference's periodic runOnce provides.

Events arriving WHILE a cycle runs batch into the next ``wait()``'s first
look (the pending counter persists across cycles), and a batch already
waiting when ``wait()`` is entered fires immediately — its debounce was
paid while the previous cycle ran.

``SCHEDULER_TORCH_TRIGGER={period,event}`` selects the loop
(``scheduler_tpu_torch/scheduler.py``); the default ``period`` path is the
fixed-cadence loop.  All knobs parse through ``utils/envflags``, with the
JAX package's defaults and choices (``scheduler_tpu/utils/trigger.py``; the
design is in ``docs/CHURN.md``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# Shutdown responsiveness bound: wait() sleeps in slices no longer than
# this so an externally-set stop event is noticed promptly even when no
# trigger events arrive (the journal watch long-poll uses the same idea).
_STOP_SLICE_S = 0.25


def trigger_mode_from_env() -> str:
    """The cycle-pacing mode configured by ``SCHEDULER_TORCH_TRIGGER``:
    ``period`` (default — the pre-existing fixed-cadence loop) or ``event``
    (block on the connector's event trigger; docs/CHURN.md)."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_TRIGGER", "period", choices=("period", "event"))


class CycleTrigger:
    """Debounced, clamped cycle pacemaker fed by the connector's event seam.

    Thread model: any number of producer threads call ``notify()``; exactly
    ONE consumer thread calls ``wait()`` (the scheduler loop).  The clock and
    sleep are injectable so tests drive the pacing deterministically."""

    def __init__(
        self,
        debounce: float = 0.025,
        min_interval: float = 0.0,
        max_interval: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Optional[Callable[[float], None]] = None,
    ) -> None:
        if debounce < 0 or min_interval < 0 or max_interval <= 0:
            raise ValueError(
                f"malformed trigger intervals ({debounce=}, {min_interval=}, "
                f"{max_interval=})"
            )
        self.debounce = float(debounce)
        self.min_interval = float(min_interval)
        self.max_interval = float(max_interval)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._pending = 0
        # When the CURRENT batch's first event arrived: the debounce window
        # is anchored here, so it is fixed per batch (no storm sliding) and
        # already-aged batches (events that landed while the previous cycle
        # ran) pay only the remainder, usually nothing.
        self._batch_start = 0.0
        self.total_events = 0  # lifetime notifies (evidence)
        self.cycles = 0        # lifetime wait() returns (evidence)
        self._last_fire: Optional[float] = None

    @classmethod
    def from_env(cls, default_max_interval: float = 1.0) -> "CycleTrigger":
        """Knobs from the environment (envflags).  ``default_max_interval`` is the
        configured schedule period, so a quiet cluster under ``event``
        pacing rescans exactly as often as ``period`` pacing would."""
        from scheduler_tpu_torch.utils.envflags import env_float

        debounce = env_float("SCHEDULER_TORCH_DEBOUNCE_MS", 25.0, minimum=0.0)
        min_ms = env_float("SCHEDULER_TORCH_TRIGGER_MIN_MS", 0.0, minimum=0.0)
        max_ms = env_float(
            "SCHEDULER_TORCH_TRIGGER_MAX_MS",
            max(1.0, default_max_interval * 1000.0),
            minimum=1.0,
        )
        # A max interval below the min clamp would deadlock the quiet-cluster
        # fallback behind the floor; the floor wins the conflict.
        max_ms = max(max_ms, min_ms)
        return cls(
            debounce=debounce / 1000.0,
            min_interval=min_ms / 1000.0,
            max_interval=max_ms / 1000.0,
        )

    # -- producer side (connector watch threads) -----------------------------

    def notify(self, count: int = 1) -> None:
        """Record ``count`` applied events and wake the consumer."""
        if count <= 0:
            return
        with self._lock:
            if self._pending == 0:
                self._batch_start = self._clock()
            self._pending += count
            self.total_events += count
            self._event.set()

    def pending(self) -> int:
        with self._lock:
            return self._pending

    # -- consumer side (the scheduler loop) ----------------------------------

    def _wait_slice(self, seconds: float, stop: Optional[threading.Event]) -> None:
        """Sleep ``seconds`` responsively: injected sleep (tests) sleeps in
        one shot; the real path slices so ``stop`` is honored promptly."""
        if self._sleep is not None:
            self._sleep(seconds)
            return
        deadline = self._clock() + seconds
        while (stop is None or not stop.is_set()):
            left = deadline - self._clock()
            if left <= 0:
                return
            time.sleep(min(left, _STOP_SLICE_S))

    def wait(self, stop: Optional[threading.Event] = None) -> int:
        """Block until the next cycle should fire; return the number of
        events the cycle consumes (0 == max-interval fallback rescan, or
        ``stop`` was set).  The consumed counter resets, so each event is
        charged to exactly one cycle."""
        now = self._clock()
        if self._last_fire is not None and self.min_interval > 0.0:
            floor = self._last_fire + self.min_interval - now
            if floor > 0:
                self._wait_slice(floor, stop)
        start = self._clock()
        deadline = (
            self._last_fire if self._last_fire is not None else start
        ) + self.max_interval
        # Phase 1: wait for the first event (or the max-interval deadline).
        first_seen = self.pending() > 0
        while not first_seen and (stop is None or not stop.is_set()):
            left = deadline - self._clock()
            if left <= 0:
                break
            if self._event.wait(timeout=min(left, _STOP_SLICE_S)):
                first_seen = self.pending() > 0
                if not first_seen:
                    # Spurious wake (a racing consume cleared the batch):
                    # drop the flag and keep waiting.
                    with self._lock:
                        if self._pending == 0:
                            self._event.clear()
        # Phase 2: debounce anchored at the batch's FIRST event — fixed per
        # batch (a storm cannot slide it), and a batch that aged through
        # the previous cycle pays only the remainder (usually nothing).
        if first_seen and self.debounce > 0.0:
            with self._lock:
                left = self._batch_start + self.debounce - self._clock()
            if left > 0:
                self._wait_slice(left, stop)
        with self._lock:
            consumed = self._pending
            self._pending = 0
            self._event.clear()
        self._last_fire = self._clock()
        self.cycles += 1
        return consumed
