"""Per-cycle phase accounting: named wall-clock blocks and notes.

A measurement protocol calls ``begin()``, runs a cycle, and reads the
``{phase: seconds}`` map from ``end()`` and the non-time annotations from
``take_notes()``.  Outside ``begin()``/``end()`` every call is a no-op.  The
JAX package routes the same API into its flight recorder; this package keeps
only the accounting.  Not thread-safe: cycles are single-threaded.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

_phases: Optional[Dict[str, float]] = None
_notes: Dict[str, object] = {}


def begin() -> None:
    """Start collecting phases for one cycle."""
    global _phases
    _phases = {}
    _notes.clear()


def end() -> Dict[str, float]:
    """Stop collecting; return {phase: seconds} accumulated since begin()."""
    global _phases
    out, _phases = _phases or {}, None
    return out


def take_notes() -> Dict[str, object]:
    """Non-time annotations recorded during the cycle.  Read before ``end()``."""
    out = dict(_notes)
    _notes.clear()
    return out


def add(name: str, secs: float) -> None:
    if _phases is not None:
        _phases[name] = _phases.get(name, 0.0) + secs


def note(name: str, value) -> None:
    """Attach a non-time annotation to the cycle being measured."""
    if _phases is not None:
        _notes[name] = value


@contextlib.contextmanager
def phase(name: str):
    """Time one named block into the cycle record."""
    start = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - start)
