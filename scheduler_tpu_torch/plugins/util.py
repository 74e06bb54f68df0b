"""Host-side scoring helpers (reference ``pkg/scheduler/plugins/util``).

The requested/allocatable fraction math of binpack's host callback.  The
mega kernel scores with the same formula (``ops/megakernel.py``); the
fused-route-versus-host-loop tests tie the two together.
"""

from __future__ import annotations

import numpy as np

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.vocab import CPU, MEMORY


def requested_fractions(task: TaskInfo, node: NodeInfo):
    """(allocatable, requested-after-placement, safe divisor) vectors."""
    alloc = node.allocatable.array
    idle = node.idle.array
    req = task.resreq.array
    n = min(len(alloc), len(idle), len(req))
    requested = alloc[:n] - idle[:n] + req[:n]
    safe = np.where(alloc[:n] > 0, alloc[:n], 1.0)
    return alloc[:n], requested, safe


def binpack_host(task: TaskInfo, node: NodeInfo) -> float:
    alloc, requested, safe = requested_fractions(task, node)
    frac = np.clip(requested / safe, 0.0, 1.0)
    return float((frac[CPU] + frac[MEMORY]) / 2.0 * 10.0)
