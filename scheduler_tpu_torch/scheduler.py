"""The scheduler loop: conf-ordered actions over periodic sessions.

Reference: ``pkg/scheduler/scheduler.go`` — ``NewScheduler`` holds cache +
actions + plugin tiers (:45-60), ``Run`` starts the cache and ticks
``runOnce`` every schedule period (:63-86), and ``runOnce`` opens a session,
executes each configured action with a latency metric, and closes (:88-102).
Configuration is read once at ``run`` (no hot reload), like the reference.

``SCHEDULER_TORCH_TRIGGER=event`` replaces the fixed tick with the
connector's watch-event trigger (``utils/trigger.py``), as the JAX package's
``SCHEDULER_TPU_TRIGGER`` does.

``device`` (default None: CUDA) is where the session's engines run; with no
GPU present the constructor raises instead of carrying on on the CPU.  The
cycles run in the thread that calls ``run`` (or ``run_once``): the
connector's watch and RPC threads never touch a device tensor.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import List, Optional

import scheduler_tpu_torch.actions  # noqa: F401  registry side effects (factory.go:29-35)
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu_torch.conf import SchedulerConfiguration, load_scheduler_conf
from scheduler_tpu_torch.framework import close_session, get_action, open_session
from scheduler_tpu_torch.framework.interface import Action
from scheduler_tpu_torch.ops.device import resolve_device
from scheduler_tpu_torch.utils import metrics, obs, phases, trace

logger = logging.getLogger("scheduler_tpu_torch.scheduler")


class Scheduler:
    def __init__(
        self,
        cache,
        scheduler_conf: Optional[str] = None,
        schedule_period: float = 1.0,
        profile_dir: Optional[str] = None,
        device=None,
        trigger=None,
        record_cycles: bool = False,
    ) -> None:
        self.cache = cache
        self.scheduler_conf = scheduler_conf
        self.schedule_period = schedule_period
        self.device = resolve_device(device)
        # Event-triggered pacing: a prebuilt CycleTrigger (tests, the churn
        # rig) or, under SCHEDULER_TORCH_TRIGGER=event, one that run() builds
        # from the environment.  The default period loop ticks instead.
        self.trigger = trigger
        # Per-cycle evidence for measurement protocols (the churn rig): each
        # run_once appends {s, t, events, gc, phases, notes} to cycle_log.
        self.record_cycles = record_cycles
        self.cycle_log: List[dict] = []
        self._loop_started: Optional[float] = None
        self._last_events = 0  # events the current cycle consumed
        # GC-freeze pacing: the period loop collects at the head of every
        # cycle; the event loop may fire cycles every few ms and rate-limits
        # the freeze protocol to one a _gc_min_interval instead.
        self._gc_every_cycle = True
        self._gc_min_interval = 1.0
        self._last_gc = float("-inf")
        # True while a cycle runs: measurement rigs poll it (with the
        # trigger's pending count) to detect a drained scheduler.
        self.in_cycle = False
        # torch.profiler trace directory: only the first PROFILE_CYCLES
        # cycles are traced, each into its own chrome-trace file, so a
        # long-running loop never grows the directory unboundedly.
        self.profile_dir = profile_dir
        self._profiled_cycles = 0
        self.actions: List[Action] = []
        self.conf: Optional[SchedulerConfiguration] = None

    PROFILE_CYCLES = 3

    def _load_conf(self) -> None:
        """scheduler.go:70-83: resolve the action list once, at startup."""
        self.conf = load_scheduler_conf(self.scheduler_conf)
        self.actions = [get_action(name) for name in self.conf.actions]

    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Start the cache and run cycles until ``stop`` is set.

        ``SCHEDULER_TORCH_TRIGGER=period`` (default) ticks run_once every
        schedule period — the reference's ``wait.Until(runOnce, period)``
        (scheduler.go:85).  ``event`` blocks on the connector's cycle
        trigger instead: watch events coalesce through a debounce window
        and min/max-interval clamps (utils/trigger.py)."""
        from scheduler_tpu_torch.utils.trigger import trigger_mode_from_env

        stop = stop or threading.Event()
        self.cache.run()
        self._load_conf()
        mode = "event" if self.trigger is not None else trigger_mode_from_env()
        logger.info(
            "scheduler running: actions=%s period=%.3fs trigger=%s device=%s",
            [a.name() for a in self.actions], self.schedule_period, mode,
            self.device,
        )
        self._loop_started = time.perf_counter()
        if mode == "event":
            self._run_event_loop(stop)
            return
        while not stop.is_set():
            started = time.perf_counter()
            try:
                self.run_once()
            except Exception:
                logger.exception("scheduling cycle failed")
            elapsed = time.perf_counter() - started
            stop.wait(max(0.0, self.schedule_period - elapsed))

    def _run_event_loop(self, stop: threading.Event) -> None:
        """Event-triggered cycles: block on the trigger, consume the
        coalesced event batch, run one cycle.  A wait that expires without
        events (the max-interval clamp) still runs a full rescan cycle."""
        from scheduler_tpu_torch.utils.trigger import CycleTrigger

        trigger = self.trigger
        if trigger is None:
            trigger = self.trigger = CycleTrigger.from_env(
                default_max_interval=self.schedule_period
            )
        # Wire the trigger into the connector's _apply seam (both inbound
        # protocols share it).  A cache without a connector client still
        # cycles at the max-interval fallback.
        client = self.cache.client()
        if client is not None and hasattr(client, "set_trigger"):
            client.set_trigger(trigger)
        else:
            logger.warning(
                "trigger=event without a connector client: cycles fall back "
                "to the max-interval rescan cadence"
            )
        self._gc_every_cycle = False
        while not stop.is_set():
            consumed = trigger.wait(stop)
            if stop.is_set():
                return
            self._last_events = consumed
            try:
                self.run_once()
            except Exception:
                logger.exception("scheduling cycle failed")
            finally:
                self._last_events = 0

    @staticmethod
    def _gc_freeze_enabled() -> bool:
        """The GC protocol (``SCHEDULER_TORCH_GC_FREEZE``, default on):
        collect at the head of each cycle and freeze the survivors around
        it — the long-lived cache mirrors the whole cluster, and letting the
        collector trace 100k+ objects mid-cycle costs multi-hundred-ms
        pauses inside the cycle."""
        from scheduler_tpu_torch.utils.envflags import env_bool

        return env_bool("SCHEDULER_TORCH_GC_FREEZE", True)

    def run_once(self) -> None:
        """One scheduling cycle (scheduler.go:88-102)."""
        if self.conf is None:
            self._load_conf()
        if not (self.profile_dir and self._profiled_cycles < self.PROFILE_CYCLES):
            self._run_once_inner()
            return
        path = os.path.join(
            self.profile_dir, f"cycle{self._profiled_cycles:04d}.json"
        )
        self._profiled_cycles += 1
        with trace.torch_profile(path, self.device) as written:
            self._run_once_inner()
        if not written[0]:
            # A diagnostics flag must never cost a scheduling cycle.
            logger.warning("profiling disabled after a failed trace")
            self.profile_dir = None

    def _run_once_inner(self) -> None:
        freeze = self._gc_freeze_enabled()
        if freeze and not self._gc_every_cycle:
            freeze = time.perf_counter() - self._last_gc >= self._gc_min_interval
        recording = self.record_cycles
        # The flight recorder opens a record for every cycle
        # (SCHEDULER_TORCH_OBS=0: only where a protocol opened one).  A
        # cycle inside a record that a measurement protocol opened
        # (phases.begin) records into it, and the protocol closes it.
        owner = not obs.active() and (recording or obs.enabled())
        cycle_id = obs.begin() if owner else -1
        # Before the GC block: measurement rigs poll (trigger drained and
        # not in_cycle), and a collect over a large heap could span their
        # whole double-check window.
        self.in_cycle = True
        start = time.perf_counter()
        try:
            with phases.phase("gc"):
                if freeze:
                    gc.collect()
                    gc.freeze()
                    self._last_gc = time.perf_counter()
            with trace.cycle(cycle_id), trace.maybe_profile(cycle_id, self.device):
                start = time.perf_counter()
                with phases.phase("open_session"):
                    ssn = open_session(self.cache, self.conf.tiers, device=self.device)
                try:
                    for action in self.actions:
                        action_start = time.perf_counter()
                        # One phase an action (the JAX package's "action:" spans).
                        with phases.phase(f"action:{action.name()}"):
                            action.execute(ssn)
                        metrics.update_action_duration(
                            action.name(), time.perf_counter() - action_start
                        )
                finally:
                    with phases.phase("close_session"):
                        close_session(ssn)
                metrics.update_e2e_duration(time.perf_counter() - start)
        finally:
            self.in_cycle = False
            if freeze:
                gc.unfreeze()
            if owner:
                notes = obs.take_notes()
                extra = {"events": self._last_events, "gc": freeze}
                # Ingest cost on the record: the reflectors' cumulative
                # LIST/relist bytes as of this cycle (k8s wire only).
                client = getattr(self.cache, "client", lambda: None)()
                reflectors = getattr(client, "reflectors", None)
                if reflectors:
                    extra["relist_bytes"] = sum(r.relist_bytes for r in reflectors)
                rec = obs.end(extra=extra)
                if recording:
                    base = self._loop_started
                    self.cycle_log.append({
                        "s": time.perf_counter() - start,
                        "t": (start - base) if base is not None else 0.0,
                        "events": self._last_events,
                        "gc": freeze,
                        "phases": rec,
                        "notes": notes,
                    })
