"""Env-gated runtime assertions (reference ``pkg/scheduler/util/assert/assert.go``).

By default a violated invariant logs loudly and continues (the reference behavior
when PANIC_ON_ERROR is unset); set ``PANIC_ON_ERROR=true`` to raise instead, which
the test suite does to catch resource-arithmetic bugs early.
"""

from __future__ import annotations

import logging
import traceback
from typing import Callable, Union

logger = logging.getLogger("scheduler_tpu_torch.assert")


class AssertionViolation(AssertionError):
    pass


def _panic_on_error() -> bool:
    from scheduler_tpu_torch.utils.envflags import env_bool

    # Unset -> log-and-continue (the reference default); malformed values
    # warn once and keep that default instead of silently counting as off.
    return env_bool("PANIC_ON_ERROR", False)


def assert_that(condition: bool, message: Union[str, Callable[[], str]]) -> None:
    if condition:
        return
    msg = message() if callable(message) else message
    if _panic_on_error():
        raise AssertionViolation(msg)
    logger.error("assertion violated: %s\n%s", msg, "".join(traceback.format_stack(limit=8)))
