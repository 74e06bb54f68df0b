"""Session -> engine helpers shared by the fused allocator.

The JAX package's ``ops/allocator.py`` also carries the per-pop
``DeviceAllocator`` engine; this package does not port it (sessions that
would take it run the host loop, ``actions/allocate.py``).  What the fused
allocator imports lives here: the gang ready-break probe, the pending-task
collection for custom task orders and the dynamic scorer weights.
"""

from __future__ import annotations

from typing import List, Tuple

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.types import TaskStatus


def gang_ready_active(ssn) -> bool:
    """True iff gang's job_ready veto is actually consulted: registered AND
    enabled in some tier.  When it isn't, ``ssn.job_ready`` is vacuously true
    and the allocate ready-break fires after every placement (deficit 0), so
    pops place one task then re-select — the device engine must mirror that."""
    if "gang" not in ssn.job_ready_fns:
        return False
    return any(
        p.name == "gang" and p.job_ready_enabled()
        for tier in ssn.tiers
        for p in tier.plugins
    )


def collect_pending(job: JobInfo, sort_key) -> List[TaskInfo]:
    """A job's pending, non-best-effort tasks in task order (allocate.go:119-133)."""
    pending = [
        t
        for t in job.task_status_index.get(TaskStatus.PENDING, {}).values()
        if not t.resreq_empty
    ]
    pending.sort(key=sort_key)
    return pending


def score_weights(ssn) -> Tuple[float, float, float]:
    """(least_requested, balanced, binpack) weights for the dynamic scorers."""
    w = ssn.device_score_weights
    return (
        float(w.get("least_requested", 0.0)),
        float(w.get("balanced", 0.0)),
        float(w.get("binpack", 0.0)),
    )
