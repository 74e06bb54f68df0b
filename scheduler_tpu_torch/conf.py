"""Scheduler configuration schema and YAML loading.

Reference: ``pkg/scheduler/conf/scheduler_conf.go`` (schema) and
``pkg/scheduler/util.go:31-73`` (default conf string + loader).  A configuration
is an ordered action list plus plugin *tiers*; each plugin option carries nine
optional enable flags (nil → enabled, ``plugins/defaults.go:22-52``) and a
free-form string-argument map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml

# Compiled-in default configuration.  The reference's default (util.go:31-42)
# names actions and plugins this package does not carry; the default here is
# the flagship allocate cycle (BASELINE config 3) over the builtin set.
DEFAULT_SCHEDULER_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: binpack
"""

_FLAG_NAMES = (
    "enabledJobOrder",
    "enabledJobReady",
    "enabledJobPipelined",
    "enabledTaskOrder",
    "enabledPreemptable",
    "enabledReclaimable",
    "enabledQueueOrder",
    "enabledPredicate",
    "enabledNodeOrder",
)


@dataclass
class PluginOption:
    """One plugin within a tier.  A ``None`` flag means "enabled" (defaults.go)."""

    name: str
    enabled_job_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    arguments: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def _is_enabled(flag: Optional[bool]) -> bool:
        return flag is None or flag

    # Convenience accessors used by the Session dispatchers.
    def job_order_enabled(self) -> bool:
        return self._is_enabled(self.enabled_job_order)

    def job_ready_enabled(self) -> bool:
        return self._is_enabled(self.enabled_job_ready)

    def job_pipelined_enabled(self) -> bool:
        return self._is_enabled(self.enabled_job_pipelined)

    def task_order_enabled(self) -> bool:
        return self._is_enabled(self.enabled_task_order)

    def preemptable_enabled(self) -> bool:
        return self._is_enabled(self.enabled_preemptable)

    def reclaimable_enabled(self) -> bool:
        return self._is_enabled(self.enabled_reclaimable)

    def queue_order_enabled(self) -> bool:
        return self._is_enabled(self.enabled_queue_order)

    def predicate_enabled(self) -> bool:
        return self._is_enabled(self.enabled_predicate)

    def node_order_enabled(self) -> bool:
        return self._is_enabled(self.enabled_node_order)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    actions: List[str] = field(default_factory=list)
    tiers: List[Tier] = field(default_factory=list)


def _camel_to_snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def parse_scheduler_conf(conf_str: str) -> SchedulerConfiguration:
    """Parse a YAML configuration string (reference loadSchedulerConf, util.go:44-73)."""
    raw = yaml.safe_load(conf_str) or {}
    actions_str = raw.get("actions", "")
    actions = [a.strip() for a in actions_str.split(",") if a.strip()]

    tiers: List[Tier] = []
    for tier_raw in raw.get("tiers") or []:
        plugins: List[PluginOption] = []
        for p_raw in tier_raw.get("plugins") or []:
            opt = PluginOption(name=p_raw["name"])
            for flag in _FLAG_NAMES:
                if flag in p_raw:
                    setattr(opt, _camel_to_snake(flag), bool(p_raw[flag]))
            args = p_raw.get("arguments") or {}
            opt.arguments = {str(k): str(v) for k, v in args.items()}
            plugins.append(opt)
        tiers.append(Tier(plugins=plugins))

    return SchedulerConfiguration(actions=actions, tiers=tiers)


def load_scheduler_conf(path: Optional[str]) -> SchedulerConfiguration:
    """Load from file, falling back to the compiled-in default."""
    if path:
        with open(path, "r") as f:
            return parse_scheduler_conf(f.read())
    return parse_scheduler_conf(DEFAULT_SCHEDULER_CONF)
