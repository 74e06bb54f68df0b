"""Conformance plugin: never evict critical system pods
(reference ``plugins/conformance/conformance.go:40-63``)."""

from __future__ import annotations

from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import Plugin

CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")
KUBE_SYSTEM_NAMESPACE = "kube-system"


def _is_critical(task) -> bool:
    pod = task.pod
    return (
        pod.priority_class_name in CRITICAL_PRIORITY_CLASSES
        or pod.namespace == KUBE_SYSTEM_NAMESPACE
    )


class ConformancePlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    def name(self) -> str:
        return "conformance"

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor, evictees):
            victims = None
            for evictee in evictees:
                if _is_critical(evictee):
                    continue
                victims = victims or []
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(self.name(), evictable_fn)
        ssn.add_reclaimable_fn(self.name(), evictable_fn)


def new(arguments: Arguments) -> ConformancePlugin:
    return ConformancePlugin(arguments)
