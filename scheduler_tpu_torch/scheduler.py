"""The scheduler loop: conf-ordered actions over periodic sessions.

Reference: ``pkg/scheduler/scheduler.go`` — ``NewScheduler`` holds cache +
actions + plugin tiers (:45-60), ``Run`` starts the cache and ticks
``runOnce`` every schedule period (:63-86), and ``runOnce`` opens a session,
executes each configured action with a latency metric, and closes (:88-102).
Configuration is read once at ``run`` (no hot reload), like the reference.

``device`` (default None: CUDA) is where the session's engines run; with no
GPU present the constructor raises instead of carrying on on the CPU.
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
from scheduler_tpu_torch.utils import metrics, phases

logger = logging.getLogger("scheduler_tpu_torch.scheduler")


class Scheduler:
    def __init__(
        self,
        cache,
        scheduler_conf: Optional[str] = None,
        schedule_period: float = 1.0,
        profile_dir: Optional[str] = None,
        device=None,
    ) -> None:
        self.cache = cache
        self.scheduler_conf = scheduler_conf
        self.schedule_period = schedule_period
        self.device = resolve_device(device)
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
        """Start the cache and run cycles every schedule period until
        ``stop`` is set (the reference's ``wait.Until(runOnce, period)``)."""
        stop = stop or threading.Event()
        self.cache.run()
        self._load_conf()
        logger.info(
            "scheduler running: actions=%s period=%.3fs device=%s",
            [a.name() for a in self.actions], self.schedule_period, self.device,
        )
        while not stop.is_set():
            started = time.perf_counter()
            try:
                self.run_once()
            except Exception:
                logger.exception("scheduling cycle failed")
            elapsed = time.perf_counter() - started
            stop.wait(max(0.0, self.schedule_period - elapsed))

    def run_once(self) -> None:
        """One scheduling cycle (scheduler.go:88-102)."""
        if self.conf is None:
            self._load_conf()
        if not (self.profile_dir and self._profiled_cycles < self.PROFILE_CYCLES):
            self._run_once_inner()
            return
        import torch

        path = os.path.join(
            self.profile_dir, f"cycle{self._profiled_cycles:04d}.json"
        )
        self._profiled_cycles += 1
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            self._run_once_inner()
        prof.export_chrome_trace(path)

    def _run_once_inner(self) -> None:
        # GC protocol: collect at the HEAD of each cycle and freeze the
        # survivors around it — the long-lived cache mirrors the whole
        # cluster, and letting the collector trace 100k+ objects mid-cycle
        # costs multi-hundred-ms pauses inside the cycle.
        with phases.phase("gc"):
            gc.collect()
            gc.freeze()
        try:
            start = time.perf_counter()
            with phases.phase("open_session"):
                ssn = open_session(self.cache, self.conf.tiers, device=self.device)
            try:
                for action in self.actions:
                    action_start = time.perf_counter()
                    action.execute(ssn)
                    metrics.update_action_duration(
                        action.name(), time.perf_counter() - action_start
                    )
            finally:
                with phases.phase("close_session"):
                    close_session(ssn)
            metrics.update_e2e_duration(time.perf_counter() - start)
        finally:
            gc.unfreeze()
