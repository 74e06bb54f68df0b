"""Global action and plugin-builder registries
(reference ``framework/plugins.go:27-72``)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from scheduler_tpu_torch.framework.arguments import Arguments
    from scheduler_tpu_torch.framework.interface import Action, Plugin

PluginBuilder = Callable[["Arguments"], "Plugin"]

_lock = threading.Lock()
_plugin_builders: Dict[str, PluginBuilder] = {}
_actions: Dict[str, "Action"] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    with _lock:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    with _lock:
        return _plugin_builders.get(name)


def register_action(action: "Action") -> None:
    with _lock:
        _actions[action.name()] = action


def get_action(name: str) -> Optional["Action"]:
    with _lock:
        return _actions.get(name)
