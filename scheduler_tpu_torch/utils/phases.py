"""Per-cycle phase accounting: named wall-clock blocks and notes.

A measurement protocol calls ``begin()``, runs a cycle, and reads the
non-time annotations from ``take_notes()`` and the ``{phase: seconds}`` map
from ``end()``.  Outside a record every call is a no-op.  This is the
measurement frontend of the flight recorder (``utils/obs.py``): the
scheduler loop opens a record for every cycle, and a cycle run inside a
record the protocol opened records into it.  Not thread-safe: cycles are
single-threaded.
"""

from __future__ import annotations

from typing import Dict

from scheduler_tpu_torch.utils import obs


def begin() -> None:
    """Start collecting phases for one cycle."""
    obs.begin()


def end() -> Dict[str, float]:
    """Stop collecting; return {phase: seconds} accumulated since begin().
    The closed record also lands in the flight-recorder ring
    (``/debug/cycles``) unless ``SCHEDULER_TORCH_OBS=0``."""
    return obs.end()


def take_notes() -> Dict[str, object]:
    """Non-time annotations recorded during the cycle.  Read before ``end()``."""
    return obs.take_notes()


def active() -> bool:
    """True between ``begin()`` and ``end()``."""
    return obs.active()


def get_note(name: str):
    """The note ``name`` recorded so far in this cycle (None if none),
    without taking the notes."""
    return obs.get_note(name)


def add(name: str, secs: float) -> None:
    obs.add(name, secs)


def note(name: str, value) -> None:
    """Attach a non-time annotation to the cycle being measured."""
    obs.note(name, value)


# Time one named block into the cycle record; also a trace span when
# SCHEDULER_TORCH_TRACE armed the cycle (utils/trace.py).
phase = obs.phase
