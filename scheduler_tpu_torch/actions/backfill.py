"""Backfill: place zero-request (BestEffort) tasks wherever predicates pass
(reference ``actions/backfill/backfill.go``; ``scheduler_tpu/actions/backfill.py``
in its default ``host`` flavor).

The per-task sweep takes the first node, in node-name order, whose
predicates pass and whose bind succeeds, and records FitErrors for a task
that fits nowhere.  With the cohort fast-start: BestEffort pods mostly
share one static-predicate signature (selector, tolerations, node
affinity), and the sweep would re-scan the same failing node prefix for
each of them.  When every registered predicate is signature-static (each
plugin registered a ``static_predicate_fn``) and the task carries no
scan-dynamic predicate (host ports, inter-pod affinity), a node that failed
for the previous task of the signature fails for the next one too: the
static predicates see the same inputs, and the live gate, the pod count,
only tightens while backfill allocates.  The sweep therefore starts at the
last success of the signature, capped at the first node whose bind failed
(it passed predicates, so the next task must retry it).  A task whose
fast-started sweep finds nothing sweeps the skipped prefix too, into the
same FitErrors, so the record stays the reference's.

Two flavors: ``SCHEDULER_TORCH_BACKFILL=host`` (default) runs the sweep
above; ``device`` consults ``ops/backfill.py``, the batched class engine
(the static-predicate kernel on backfill's signature classes), and falls
back here, with its decline reason in the ``backfill`` evidence, whenever
the session leaves the engine's modeled domain.
"""

from __future__ import annotations

import logging

from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.api.unschedule_info import FitErrors
from scheduler_tpu_torch.apis.objects import PodGroupPhase
from scheduler_tpu_torch.framework.interface import Action
from scheduler_tpu_torch.ops import backfill as backfill_ops
from scheduler_tpu_torch.utils import phases
from scheduler_tpu_torch.utils.scheduler_helper import get_node_list
from scheduler_tpu_torch.utils.sweep import static_predicate_sig

logger = logging.getLogger("scheduler_tpu_torch.actions.backfill")


class BackfillAction(Action):
    # Host predicate calls of the current execution (evidence).
    _pred_calls = 0

    def name(self) -> str:
        return "backfill"

    def execute(self, ssn) -> None:
        # Its own phase, so a cycle's host time splits between allocate's
        # phases and backfill.
        with phases.phase("backfill"):
            self._execute(ssn)

    def _sweep(self, ssn, task, nodes, start, fe, end=None):
        """The reference's first-passing-node sweep over ``[start, end)``:
        ``(winning index or None, first bind-failure index or None)``, the
        errors into ``fe``."""
        first_bind_fail = None
        for idx in range(start, len(nodes) if end is None else end):
            node = nodes[idx]
            self._pred_calls += 1
            try:
                ssn.predicate_fn(task, node)
            except Exception as err:
                logger.debug("backfill predicate failed for %s on %s: %s",
                             task.uid, node.name, err)
                fe.set_node_error(node.name, err)
                continue
            try:
                ssn.allocate(task, node.name)
            except Exception as err:
                logger.error("backfill bind of %s on %s failed: %s",
                             task.uid, node.name, err)
                fe.set_node_error(node.name, err)
                if first_bind_fail is None:
                    first_bind_fail = idx
                continue
            return idx, first_bind_fail
        return None, first_bind_fail

    def _execute(self, ssn) -> None:
        engine = backfill_ops.BackfillEngine(ssn)
        if engine.active:
            engine.run()
            backfill_ops.note_evidence(engine.stats())
            return
        stats = engine.stats()
        self._pred_calls = 0
        host = self._execute_host(ssn)
        host["predicate_calls_host"] = self._pred_calls
        stats.update(host)
        backfill_ops.note_evidence(stats)

    def _execute_host(self, ssn) -> dict:
        nodes = None  # built at the first BestEffort task
        # The fast-start is sound only when every registered predicate is
        # signature-static; a task with a scan-dynamic predicate opts out.
        cohorts_sound = set(ssn.predicate_fns) <= set(ssn.static_predicate_fns)
        start_at: dict = {}  # signature -> end of its proven-failing prefix
        counters = {"tasks": 0, "host_binds": 0, "unplaceable": 0}
        for job in list(ssn.jobs.values()):
            if job.pod_group is not None and job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue

            for task in list(job.task_status_index.get(TaskStatus.PENDING, {}).values()):
                if not task.init_resreq.is_empty():
                    continue  # only BestEffort tasks backfill
                counters["tasks"] += 1
                if nodes is None:
                    nodes = get_node_list(ssn.nodes)
                key = static_predicate_sig(task) if cohorts_sound else None
                start = start_at.get(key, 0) if key is not None else 0
                fe = FitErrors()
                won, bind_fail = self._sweep(ssn, task, nodes, start, fe)
                if won is None and start > 0:
                    # Sweep the skipped prefix too, into the same FitErrors:
                    # it fails again by construction, and a broken proof
                    # shows as the reference's placement, not a lost one.
                    won, bind_fail = self._sweep(ssn, task, nodes, 0, fe, end=start)
                if won is None:
                    job.nodes_fit_errors[task.uid] = fe
                    counters["unplaceable"] += 1
                    continue
                counters["host_binds"] += 1
                if key is not None:
                    # Only the prefix before the first bind failure provably
                    # fails for the signature.
                    start_at[key] = won if bind_fail is None else min(won, bind_fail)
        return counters


def new() -> BackfillAction:
    return BackfillAction()
