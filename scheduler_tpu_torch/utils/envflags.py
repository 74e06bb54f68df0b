"""Hardened environment-flag parsing (``PANIC_ON_ERROR``).

A malformed flag value must not crash a scheduling cycle: an operator typo
in a deployment manifest degrades to the default instead.  This module is
the single owner of the parse-and-fallback rule:
malformed values WARN once per (flag, value) pair and fall back to the
default, they never raise.

Bool flags follow the repo-wide convention that a flag is ON unless set to
an explicit off value — but unrecognized junk ("yess", "2") now warns and
returns the DEFAULT instead of silently counting as "on".
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger("scheduler_tpu_torch.utils.envflags")

_FALSEY = ("0", "false", "no", "off")
_TRUTHY = ("1", "true", "yes", "on")

# One warning per (name, raw value): a daemon re-reads some flags every
# cycle, and a malformed value must not flood the log at cycle rate.
_warned: set = set()


def _warn_once(name: str, raw: str, default) -> None:
    key = (name, raw)
    if key in _warned:
        return
    _warned.add(key)
    logger.warning(
        "malformed %s=%r; falling back to default %r", name, raw, default
    )


def env_bool(name: str, default: bool = True) -> bool:
    """Bool env flag: unset -> ``default``; explicit on/off strings parse
    case-insensitively; anything else warns and yields ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in _FALSEY:
        return False
    if v in _TRUTHY:
        return True
    _warn_once(name, raw, default)
    return default


def env_int(
    name: str,
    default: int,
    *,
    minimum: Optional[int] = None,
    maximum: Optional[int] = None,
) -> int:
    """Integer env flag: malformed values warn and yield ``default``;
    ``minimum``/``maximum`` clamp (out-of-range is a config choice, not a
    typo, so clamping is silent)."""
    raw = os.environ.get(name)
    if raw is None:
        val = default
    else:
        try:
            val = int(raw.strip())
        except (ValueError, AttributeError):
            _warn_once(name, raw, default)
            val = default
    if minimum is not None and val < minimum:
        val = minimum
    if maximum is not None and val > maximum:
        val = maximum
    return val


def env_str(name: str, default: str, choices: Optional[tuple] = None) -> str:
    """String env flag with an optional closed choice set (warn + default on
    anything outside it)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if choices is not None and v not in choices:
        _warn_once(name, raw, default)
        return default
    return v
