"""Scheduling framework: the per-cycle Session, plugin dispatch, registries and
the Statement transaction (reference ``pkg/scheduler/framework``)."""

from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import (
    Action,
    Event,
    EventHandler,
    Plugin,
    ValidateResult,
)
from scheduler_tpu_torch.framework.registry import (
    get_action,
    get_plugin_builder,
    register_action,
    register_plugin_builder,
)
from scheduler_tpu_torch.framework.session import Session
from scheduler_tpu_torch.framework.statement import Statement
from scheduler_tpu_torch.framework.framework import open_session, close_session

__all__ = [
    "Arguments",
    "Action",
    "Event",
    "EventHandler",
    "Plugin",
    "ValidateResult",
    "get_action",
    "get_plugin_builder",
    "register_action",
    "register_plugin_builder",
    "Session",
    "Statement",
    "open_session",
    "close_session",
]
