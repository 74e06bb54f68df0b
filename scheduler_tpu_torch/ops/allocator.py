"""Session -> engine helpers shared by the fused allocator.

The JAX package's ``ops/allocator.py`` also carries the per-pop
``DeviceAllocator`` engine; this package does not port it (sessions that
would take it run the host loop, ``actions/allocate.py``).  What the fused
allocator imports lives here: the gang ready-break probe, the pending-task
collection for custom task orders, the dynamic scorer weights and the
session-static [T, N] mask/score tensors.

Plugins contribute to the static tensors through two session registries:

* ``ssn.device_predicates[name](st, device) -> bool [T, N]`` mask
  contributions (or None: no constraint this session);
* ``ssn.device_scorers[name](st, device) -> f32 [T, N]`` score
  contributions (or None).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.ops.predicates import base_static_mask
from scheduler_tpu_torch.ops.transfer_cache import to_device


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


def build_static_tensors_device(ssn, st, n_bucket: int, t_bucket: int, device):
    """Session-static ``(bool [t_bucket, n_bucket] mask, f32 [t_bucket,
    n_bucket] score)`` on ``device``: the node-ready gate AND every
    registered device predicate, plus the summed static scorer
    contributions, padded with infeasible / zero-score rows and columns."""
    t_count = max(st.tasks.count, 1)
    n = st.nodes.count
    mask = base_static_mask(t_count, to_device(st.nodes.ready, device=device))
    for builder in ssn.device_predicates.values():
        contribution = builder(st, device)
        if contribution is None:
            continue  # builder declared "no constraint this session"
        mask = mask & torch.as_tensor(contribution, dtype=torch.bool, device=device)
    score = torch.zeros((t_count, n), dtype=torch.float32, device=device)
    for builder in ssn.device_scorers.values():
        contribution = builder(st, device)
        if contribution is None:
            continue
        score = score + torch.as_tensor(contribution, dtype=torch.float32, device=device)
    # Clamp to finite values ONCE here: the kernel's any-feasible check reads
    # the winner's masked score against -inf, so a feasible node whose scorer
    # emitted -inf/NaN must not be mistaken for masked-out.
    score = torch.nan_to_num(score, nan=0.0, posinf=1e30, neginf=-1e30)
    mask_p = torch.zeros((t_bucket, n_bucket), dtype=torch.bool, device=device)
    mask_p[: mask.shape[0], :n] = mask
    score_p = torch.zeros((t_bucket, n_bucket), dtype=torch.float32, device=device)
    score_p[: score.shape[0], :n] = score
    return mask_p, score_p
