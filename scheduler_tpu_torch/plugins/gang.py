"""Gang plugin: all-or-nothing co-scheduling (reference ``plugins/gang/gang.go``).

Registers: JobValid (enough valid tasks for the gang), Preemptable/Reclaimable
veto (never shrink a running gang below min_available), job order (not-ready
jobs first), JobReady / JobPipelined, and the session-close pass that writes
Unschedulable conditions for gangs that didn't make it.
"""

from __future__ import annotations

import logging

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.api.unschedule_info import FitErrors
from scheduler_tpu_torch.apis.objects import (
    NOT_ENOUGH_PODS_REASON,
    NOT_ENOUGH_RESOURCES_REASON,
    POD_GROUP_UNSCHEDULABLE_TYPE,
    PodGroupCondition,
)
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import Plugin, ValidateResult
from scheduler_tpu_torch.utils import metrics

logger = logging.getLogger("scheduler_tpu_torch.plugins.gang")


class GangPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments

    def name(self) -> str:
        return "gang"

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(job: JobInfo):
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    False,
                    NOT_ENOUGH_PODS_REASON,
                    f"Not enough valid tasks for gang-scheduling, valid: {vtn}, min: {job.min_available}",
                )
            return None

        ssn.add_job_valid_fn(self.name(), valid_job_fn)

        def preemptable_fn(preemptor: TaskInfo, preemptees):
            victims = None
            for preemptee in preemptees:
                job = ssn.jobs[preemptee.job]
                occupied = job.ready_task_num()
                preemptable = job.min_available <= occupied - 1 or job.min_available == 1
                if not preemptable:
                    logger.debug(
                        "cannot preempt task %s/%s: gang would break",
                        preemptee.namespace,
                        preemptee.name,
                    )
                else:
                    victims = (victims or [])
                    victims.append(preemptee)
            return victims  # None (Go nil) when nothing survived

        ssn.add_reclaimable_fn(self.name(), preemptable_fn)
        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)
        ssn.add_job_ready_fn(self.name(), lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name(), lambda job: job.pipelined())

    def on_session_close(self, ssn) -> None:
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if job.ready():
                continue
            unready = job.min_available - job.ready_task_num()
            # len(store.row_of) == live task count WITHOUT materializing the
            # task-view dict (close runs for every unready job every cycle).
            msg = (
                f"{unready}/{len(job.store.row_of)} tasks in gang unschedulable: {job.fit_error()}"
            )
            job.job_fit_errors = msg
            unschedulable_jobs += 1
            metrics.update_unschedule_task_count(job.name, int(unready))
            metrics.register_job_retries(job.name)

            ssn.update_job_condition(
                job,
                PodGroupCondition(
                    type=POD_GROUP_UNSCHEDULABLE_TYPE,
                    status="True",
                    transition_id=ssn.uid,
                    reason=NOT_ENOUGH_RESOURCES_REASON,
                    message=msg,
                ),
            )

            # Allocated-but-stranded tasks inherit the job-level error.
            for ti in job.task_status_index.get(TaskStatus.ALLOCATED, {}).values():
                if job.nodes_fit_errors.get(ti.uid) is None:
                    fe = FitErrors()
                    fe.set_error(msg)
                    job.nodes_fit_errors[ti.uid] = fe

        metrics.update_unschedule_job_count(unschedulable_jobs)


def new(arguments: Arguments) -> GangPlugin:
    return GangPlugin(arguments)
