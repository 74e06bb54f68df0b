"""Structured span tracer: Chrome trace-event JSON per scheduling cycle.

The flight recorder (``utils/obs.py``) answers *what* a cycle spent its time
on (the phase split); this module answers *where inside the cycle* — nested
spans with cycle-scoped IDs covering snapshot -> open_session -> per-action ->
dispatch/readback -> plugin callbacks -> bind/evict RPCs, exported in the
Chrome trace-event format that Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly (docs/OBSERVABILITY.md "Perfetto").

Armed per cycle by the scheduler loop via ``cycle(cycle_id)`` when
``SCHEDULER_TORCH_TRACE=<dir>`` is set; each cycle exports one
``cycle<id>.trace.json`` and the directory is BOUNDED — only the newest
``SCHEDULER_TORCH_TRACE_KEEP`` (default 64) cycle files are kept, so a
long-running daemon never grows it without limit.  Disarmed, ``span()`` is
one module-flag check — the production loop pays nothing measurable.

``SCHEDULER_TORCH_PROFILE=<dir>`` additionally samples a ``torch.profiler``
trace (CPU, and CUDA on the card) every ``SCHEDULER_TORCH_PROFILE_EVERY``
(default 100) cycles, into ``<dir>/cycle<id>.pt.trace.json`` — the SAME
zero-padded cycle id the span file and the flight-recorder ring entry carry,
so a device profile, its span tree and its ring record link up by name.  The
scheduler's ``--profile-dir`` (its first cycles) records through the same
``torch_profile``.  A diagnostics flag must never cost a scheduling cycle:
any profiler/export failure logs, disables profiling, and the cycle
completes.

Spans may be emitted from IO worker threads (bind/evict RPCs overlap the
next cycle); the event buffer is lock-guarded and every event carries its
``tid``, so Perfetto renders one lane per thread.  An RPC that outlives the
cycle that issued it lands in the NEXT cycle's file — by design: the file
boundary is when the loop closed the cycle, not when its side effects
drained.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List

from scheduler_tpu_torch.utils.envflags import env_int, env_path

logger = logging.getLogger("scheduler_tpu_torch.utils.trace")

_lock = threading.Lock()
_events: List[dict] = []
_armed = False
# Tail collection: once a traced cycle has exported, spans keep buffering
# BETWEEN cycles (async bind/evict RPCs finishing in the idle gap) and land
# in the NEXT cycle's file.  Off until the first cycle arms, so a process
# that never cycles never buffers.
_tail_open = False
_EVENT_CAP = 100_000  # runaway guard: drop spans past this, never grow
_profile_seq = 0  # maybe_profile's own counter when no recorder id exists
_written: Deque[str] = deque()
_files_written = 0
_profiles_taken = 0
_profile_disabled = False
_export_disabled = False
_last_status: Dict[str, object] = {}


def trace_dir() -> str:
    return env_path("SCHEDULER_TORCH_TRACE", "")


def profile_dir() -> str:
    return env_path("SCHEDULER_TORCH_PROFILE", "")


def keep_files() -> int:
    return env_int("SCHEDULER_TORCH_TRACE_KEEP", 64, minimum=1)


def profile_every() -> int:
    return env_int("SCHEDULER_TORCH_PROFILE_EVERY", 100, minimum=1)


def enabled() -> bool:
    """Span tracing is configured (a cycle will arm it)."""
    return bool(trace_dir()) and not _export_disabled


def armed() -> bool:
    """A cycle is currently collecting spans."""
    return _armed


def emit(name: str, t0: float, dur_s: float, **args) -> None:
    """Record one complete span ("X" event).  ``t0`` is a
    ``time.perf_counter()`` reading; timestamps are microseconds on the
    perf_counter clock, consistent across every span of a process."""
    if not (_armed or _tail_open):
        return
    ev = {
        "name": name,
        "cat": "scheduler",
        "ph": "X",
        "ts": t0 * 1e6,
        "dur": dur_s * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = args
    with _lock:
        if len(_events) < _EVENT_CAP:
            _events.append(ev)


@contextmanager
def span(name: str, **args):
    """Time the enclosed block as one nested span; no-op while disarmed."""
    if not (_armed or _tail_open):
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        emit(name, t0, time.perf_counter() - t0, **args)


@contextmanager
def cycle(cycle_id: int):
    """Arm span collection for one scheduling cycle and export on exit."""
    global _armed, _tail_open
    out_dir = trace_dir()
    if not out_dir or _export_disabled or _armed:
        # _armed: a nested protocol inside an already-traced cycle (bench
        # harness under a traced daemon) must not steal the export.
        yield
        return
    if cycle_id < 0:
        # No flight-recorder id to link to (SCHEDULER_TORCH_OBS=0): number
        # trace files by export count so they still never collide.
        cycle_id = _files_written + 1
    # No buffer clear here: spans that arrived since the last export (RPCs
    # draining between cycles) belong to THIS cycle's file.
    _armed = True
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        # The cycle's own span, appended while still armed so it wraps
        # everything in the viewer.
        emit("cycle", t0, dur, cycle=cycle_id)
        _armed = False
        _export(out_dir, cycle_id)
        # Tail collection only while an exporter exists to drain it: a
        # latched export failure must not leave spans buffering forever.
        _tail_open = not _export_disabled


def _export(out_dir: str, cycle_id: int) -> None:
    global _export_disabled, _files_written
    with _lock:
        events = list(_events)
        _events.clear()
    doc = {
        "traceEvents": [
            {"name": "process_name", "ph": "M", "pid": os.getpid(),
             "args": {"name": "scheduler_tpu_torch"}},
        ] + events,
        "displayTimeUnit": "ms",
        "otherData": {"cycle": cycle_id},
    }
    path = os.path.join(out_dir, f"cycle{cycle_id:08d}.trace.json")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
    except OSError:
        logger.exception("trace export to %s failed; disabling tracing", path)
        _export_disabled = True
        with _lock:
            _events.clear()  # nothing will drain the buffer anymore
        return
    _files_written += 1
    _written.append(path)
    cap = keep_files()
    while len(_written) > cap:
        old = _written.popleft()
        try:
            os.unlink(old)
        except OSError:
            pass  # already gone (operator cleanup) — pruning is best-effort
    with _lock:  # status() copies this dict from the HTTP thread
        _last_status.update({"cycle": cycle_id, "events": len(events),
                             "path": path})


@contextmanager
def torch_profile(path: str, device):
    """One ``torch.profiler`` trace around the enclosed block, exported as a
    Chrome trace to ``path`` (CUDA activity too where ``device`` is a CUDA
    device).  Yields a one-element list that holds, once the block has
    ended, whether the trace was written: a setup or export failure logs and
    leaves the block's own result alone."""
    import torch

    written = [False]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:
        logger.exception("profiler trace setup failed")
        prof = None
    try:
        yield written
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                prof.export_chrome_trace(path)
                written[0] = True
            except Exception:
                logger.exception("profiler trace export to %s failed", path)


@contextmanager
def maybe_profile(cycle_id: int, device=None):
    """Sampled ``torch.profiler`` trace around one cycle: every
    ``SCHEDULER_TORCH_PROFILE_EVERY`` cycles when ``SCHEDULER_TORCH_PROFILE``
    is a directory, written to ``<dir>/cycle<id>.pt.trace.json`` (same id as
    the span file and the ring entry).  A failure disables sampling."""
    global _profile_disabled, _profiles_taken, _profile_seq
    out_dir = profile_dir()
    if not out_dir or _profile_disabled:
        yield
        return
    if cycle_id < 0:
        # No flight-recorder id (SCHEDULER_TORCH_OBS=0): sample on this
        # context's own call counter so profiling stays live, mirroring
        # cycle()'s file-count fallback.
        _profile_seq += 1
        cycle_id = _profile_seq
    if cycle_id % profile_every():
        yield
        return
    target = os.path.join(out_dir, f"cycle{cycle_id:08d}.pt.trace.json")
    with torch_profile(target, device) as written:
        yield
    if written[0]:
        _profiles_taken += 1
    else:
        _profile_disabled = True


def status() -> dict:
    """The /debug/trace payload: configuration + last-export summary."""
    with _lock:
        last = dict(_last_status)
        buffered = len(_events)
    return {
        "enabled": enabled(),
        "armed": _armed,
        "dir": trace_dir() or None,
        "keep": keep_files(),
        "files_written": _files_written,
        "buffered_events": buffered,
        "last_export": last or None,
        "profile": {
            "dir": profile_dir() or None,
            "every": profile_every(),
            "taken": _profiles_taken,
            "disabled": _profile_disabled,
        },
    }


def reset() -> None:
    """Test hook: forget written files and failure latches."""
    global _armed, _tail_open, _files_written, _profiles_taken
    global _profile_disabled, _export_disabled, _profile_seq
    with _lock:
        _events.clear()
        _last_status.clear()
    _written.clear()
    _armed = False
    _tail_open = False
    _files_written = 0
    _profiles_taken = 0
    _profile_seq = 0
    _profile_disabled = False
    _export_disabled = False
