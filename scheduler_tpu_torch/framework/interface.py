"""Action / Plugin interfaces and session events
(reference ``framework/interface.go:20-42``, ``event.go:24-32``)."""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

if TYPE_CHECKING:
    from scheduler_tpu_torch.api.job_info import TaskInfo
    from scheduler_tpu_torch.framework.session import Session


class Action(abc.ABC):
    """One scheduling pass over a Session (enqueue/allocate/backfill/preempt/reclaim)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def initialize(self) -> None:
        pass

    @abc.abstractmethod
    def execute(self, ssn: "Session") -> None: ...

    def uninitialize(self) -> None:
        pass


class Plugin(abc.ABC):
    """A policy: registers callbacks into the Session on open."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def on_session_open(self, ssn: "Session") -> None: ...

    def on_session_close(self, ssn: "Session") -> None:
        pass


@dataclass
class Event:
    task: "TaskInfo"


@dataclass
class EventHandler:
    """Callbacks fired on session allocate/deallocate so plugins keep shares live.

    ``bulk_allocate_func`` is the device-engine extension: when a whole device
    placement commits at once, a handler that provides it receives ONE call with
    the full ``List[TaskInfo]`` (no per-task Event wrappers), so plugins can
    update shares with vectorized arithmetic.  Must be state-equivalent to
    folding allocate_func over per-task Events for the same tasks.
    """

    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    bulk_allocate_func: Optional[Callable[..., None]] = None  # (tasks, plan=None)
    # Bulk mirror for evictions (preempt/reclaim commit batches of victims):
    # one call with the task list, state-equivalent to folding
    # deallocate_func over per-task Events.
    bulk_deallocate_func: Optional[Callable[..., None]] = None  # (tasks)


@dataclass
class ValidateResult:
    """Result of a JobValid check (reference api/types.go ValidateResult)."""

    passed: bool
    reason: str = ""
    message: str = ""
