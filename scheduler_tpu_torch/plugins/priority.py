"""Priority plugin: pod-priority task order, PriorityClass job order
(reference ``plugins/priority/priority.go``)."""

from __future__ import annotations

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import Plugin


class PriorityPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    def name(self) -> str:
        return "priority"

    def on_session_open(self, ssn) -> None:
        def task_order_fn(l: TaskInfo, r: TaskInfo) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name(), task_order_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)


def new(arguments: Arguments) -> PriorityPlugin:
    return PriorityPlugin(arguments)
