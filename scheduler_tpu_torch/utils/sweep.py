"""The static-predicate signature of a task (``scheduler_tpu/utils/sweep.py``
``static_predicate_sig``).

Tasks that share it see the same static-predicate result on every node,
which is what lets backfill's sweep start past a node prefix proven to fail
(``actions/backfill.py``).  The JAX module's preempt / reclaim sweep cache
(``SweepCache``, ``full_sweep``) comes with those actions.
"""

from __future__ import annotations

from typing import Optional

from scheduler_tpu_torch.api.job_info import TaskInfo


def static_predicate_sig(task: TaskInfo) -> Optional[tuple]:
    """Signature of everything the static predicates read from a task, or
    None when the task carries a scan-dynamic predicate (host ports,
    inter-pod (anti-)affinity) and needs the exact per-task sweep."""
    pod = task.pod
    if pod is None:
        return None
    aff = pod.affinity
    if pod.host_ports or (aff and (aff.pod_affinity or aff.pod_anti_affinity)):
        return None
    return (
        repr(sorted(pod.node_selector.items())),
        repr(pod.tolerations),
        repr(aff.node_required) if aff else "",
        repr(getattr(aff, "node_preferred", None)) if aff else "",
    )
