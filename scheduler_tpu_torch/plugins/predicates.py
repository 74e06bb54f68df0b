"""Predicates plugin: hard feasibility constraints
(reference ``plugins/predicates/predicates.go``).

Host path (exact, always registered): pod-count limit, node readiness /
unschedulable, node selector + required node affinity, taints vs tolerations,
host-port conflicts, optional memory/disk/PID pressure gates (via arguments),
and required inter-pod (anti-)affinity.

Device path: registers a [T, N] static-mask builder (selector + affinity +
taints + unschedulable + pressure) and turns on the in-kernel pod-count gate.
The selector/taint/unschedulable rows are computed per signature by the
static-predicate kernel (``ops/predicate_kernel.py``).  Host ports and
inter-pod affinity depend on placements made *during* the action, which the
static mask can't see — tasks that use them are published in
``ssn.device_dynamic_task_uids`` and the allocate action routes their jobs
through the exact host loop; every other job stays on the device engine.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.unschedule_info import (
    FitError,
    NODE_POD_NUMBER_EXCEEDED,
)
from scheduler_tpu_torch.apis.objects import Affinity, NodeSpec, PodSpec
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import Plugin

MEMORY_PRESSURE_ARG = "predicate.MemoryPressureEnable"
DISK_PRESSURE_ARG = "predicate.DiskPressureEnable"
PID_PRESSURE_ARG = "predicate.PIDPressureEnable"

_PRESSURE_CONDITIONS = {
    MEMORY_PRESSURE_ARG: "MemoryPressure",
    DISK_PRESSURE_ARG: "DiskPressure",
    PID_PRESSURE_ARG: "PIDPressure",
}


def node_selector_matches(pod: PodSpec, node: NodeSpec) -> bool:
    """PodMatchNodeSelector: selector map + required node affinity terms."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    aff: Optional[Affinity] = pod.affinity
    if aff is not None and aff.node_required:
        # OR over term groups, AND within a group.
        if not any(
            all(req.matches(node.labels) for req in group) for group in aff.node_required
        ):
            return False
    return True


def tolerates_node_taints(pod: PodSpec, node: NodeSpec) -> bool:
    for taint in node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(tol.tolerates(taint) for tol in pod.tolerations):
            return False
    return True


def host_ports_free(pod: PodSpec, node: NodeInfo) -> bool:
    if not pod.host_ports:
        return True
    used = set()
    for task in node.tasks.values():
        used.update(task.pod.host_ports)
    return not (set(pod.host_ports) & used)


class PredicatesPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.pressure_checks: List[str] = [
            cond
            for arg, cond in _PRESSURE_CONDITIONS.items()
            if arguments.get_bool(arg, False)
        ]

    def name(self) -> str:
        return "predicates"

    # -- pod (anti-)affinity over the live session state ----------------------

    @staticmethod
    def _pods_in_topology_domain(ssn, node: NodeInfo, topology_key: str):
        """All tasks on nodes sharing this node's topology value."""
        if node.node is None:
            return
        value = node.node.labels.get(topology_key)
        if topology_key == "kubernetes.io/hostname" and value is None:
            value = node.name
        for other in ssn.nodes.values():
            if other.node is None:
                continue
            other_val = other.node.labels.get(topology_key)
            if topology_key == "kubernetes.io/hostname" and other_val is None:
                other_val = other.name
            if other_val is not None and other_val == value:
                yield from other.tasks.values()

    @classmethod
    def _term_matches_some_pod(cls, ssn, term, task: TaskInfo, node: NodeInfo) -> bool:
        namespaces = term.namespaces or [task.namespace]
        for other in cls._pods_in_topology_domain(ssn, node, term.topology_key):
            if other.uid == task.uid:
                continue
            if other.namespace not in namespaces:
                continue
            if term.matches_labels(other.pod.labels):
                return True
        return False

    def _pod_affinity_ok(self, ssn, task: TaskInfo, node: NodeInfo) -> bool:
        aff = task.pod.affinity
        if aff is None:
            return True
        for term in aff.pod_affinity:
            if not self._term_matches_some_pod(ssn, term, task, node):
                return False
        for term in aff.pod_anti_affinity:
            if self._term_matches_some_pod(ssn, term, task, node):
                return False
        return True

    # -- session wiring --------------------------------------------------------

    def on_session_open(self, ssn) -> None:
        plugin = self

        def static_predicate(task: TaskInfo, node: NodeInfo) -> None:
            """Node/pod-spec checks that cannot change during an action:
            everything in ``predicate`` except pod count (live node state),
            host ports, and inter-pod affinity (placement-dependent)."""
            if node.node is None:
                raise FitError(task.name, node.name, "node(s) not ready")
            if node.node.unschedulable:
                raise FitError(task.name, node.name, "node(s) were unschedulable")
            for cond in plugin.pressure_checks:
                if node.node.conditions.get(cond) == "True":
                    raise FitError(task.name, node.name, f"node(s) had {cond}")
            if not node_selector_matches(task.pod, node.node):
                raise FitError(task.name, node.name, "node(s) didn't match node selector")
            if not tolerates_node_taints(task.pod, node.node):
                raise FitError(
                    task.name, node.name, "node(s) had taints that the pod didn't tolerate"
                )

        def predicate(task: TaskInfo, node: NodeInfo) -> None:
            # NodePodNumber (predicates.go:162-166)
            if len(node.tasks) >= node.pods_limit:
                raise FitError(task.name, node.name, NODE_POD_NUMBER_EXCEEDED)
            static_predicate(task, node)
            if not host_ports_free(task.pod, node):
                raise FitError(task.name, node.name, "node(s) didn't have free ports")
            if not plugin._pod_affinity_ok(ssn, task, node):
                raise FitError(
                    task.name, node.name, "node(s) didn't satisfy inter-pod (anti-)affinity"
                )

        ssn.add_predicate_fn(self.name(), predicate)
        ssn.add_static_predicate_fn(self.name(), static_predicate)

        # Device path: the static constraints always compile to the [T, N]
        # mask.  Tasks using scan-dynamic predicates (host ports, inter-pod
        # (anti-)affinity depend on placements made DURING the action) are
        # published per-task instead of de-accelerating the whole session:
        # the allocate action routes their jobs through the exact host loop
        # while every other job stays on the device engine.  The sweep is
        # COLUMNAR (store flag columns, no task views): only allocate-
        # eligible pending rows matter.
        for job in ssn.jobs.values():
            rows = job.pending_rows()
            if rows.shape[0] == 0:
                continue
            st = job.store
            dmask = st.dyn_pred[rows]
            if dmask.any():
                ssn.device_dynamic_task_uids.update(st.uids[rows[dmask]].tolist())

        ssn.add_device_predicate(self.name(), self._device_mask_builder(ssn))
        ssn.device_dynamic_gates.add("pod_count")

    def _device_mask_builder(self, ssn):
        pressure_checks = list(self.pressure_checks)

        def build(st, device):
            """[T, N] static mask as a bool tensor on ``device``, assembled
            from per-SIGNATURE rows: a signature is the task's (selector,
            tolerations, unknown-flag) byte row, and its row comes from the
            static-predicate kernel at signature width."""
            t = st.tasks.count
            if t == 0:
                return torch.ones((0, st.nodes.count), dtype=torch.bool, device=device)
            mask = self._assemble_signature_mask(ssn, st, pressure_checks, device)

            # Required node affinity terms (host-evaluated per affected ROW —
            # affinity tasks are few and flagged columnar; the correction
            # lands on the device as one small gather/scatter).
            aff_idx = (
                np.nonzero(st.tasks.req_aff[:t])[0]
                if st.tasks.req_aff.shape[0] >= t
                else np.zeros(0, dtype=np.int64)
            )
            if aff_idx.shape[0]:
                node_specs = [ssn.nodes[name].node for name in st.nodes.names]
                aff_masks: List[np.ndarray] = []
                for i in aff_idx.tolist():
                    task = st.tasks.cores[i]
                    row = np.ones(st.nodes.count, dtype=bool)
                    if task is not None and task.pod.affinity is not None:
                        for j, spec in enumerate(node_specs):
                            if spec is not None and not node_selector_matches(
                                _affinity_only_pod(task.pod), spec
                            ):
                                row[j] = False
                    aff_masks.append(row)
                rows = torch.as_tensor(aff_idx.astype(np.int64), device=device)
                corr = torch.as_tensor(np.stack(aff_masks), device=device)
                mask[rows] = mask[rows] & corr
            return mask

        return build

    @staticmethod
    def _compute_sig_rows(st, sel, unk, tol, pressure_ok, device):
        """[S, N] mask rows for signature-level selector/toleration inputs,
        from the static-predicate kernel."""
        from scheduler_tpu_torch.ops.predicate_kernel import static_predicate_mask

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=bool)).to(device)

        mask = static_predicate_mask(
            dev(sel), dev(unk), dev(st.nodes.labels), dev(st.nodes.unschedulable),
            dev(st.nodes.taints), dev(tol),
        )
        if pressure_ok is not None:
            mask = mask & dev(pressure_ok)[None, :]
        return mask

    def _assemble_signature_mask(self, ssn, st, pressure_checks, device):
        """[T, N] mask rows gathered from one row a signature.  The rows are
        memoized across cycles in the owning cache's ``static_mask_cache``
        (``scheduler_tpu/plugins/predicates.py:316-345``), keyed by the node
        generation, the node count, the label and taint widths, the pressure
        checks and the device: a cycle builds with the kernel only the
        signatures the memo lacks, and none at all when it has them all.  A
        session of more than 4,096 signatures bypasses the memo; the memo
        starts over past 16,384 entries."""
        n = st.nodes.count
        l = st.tasks.selector.shape[1]
        k = st.tasks.tolerated.shape[1]
        codes, uniq = signature_codes(st)

        pressure_ok = None
        if pressure_checks:
            pressure_ok = np.ones(n, dtype=bool)
            for j, name in enumerate(st.nodes.names):
                spec = ssn.nodes[name].node
                if spec is not None and any(
                    spec.conditions.get(c) == "True" for c in pressure_checks
                ):
                    pressure_ok[j] = False

        def rows_for(uniq_subset):
            sel, unk, tol = split_signatures(uniq_subset, l, k)
            return self._compute_sig_rows(st, sel, unk, tol, pressure_ok, device)

        def gather(rows, idx):
            return rows[torch.as_tensor(idx.astype(np.int64), device=device)]

        holder = getattr(getattr(ssn, "cache", None), "static_mask_cache", None)
        snap_gen = getattr(ssn, "node_generation", -1)
        if holder is None or snap_gen < 0 or uniq.shape[0] > 4096:
            return gather(rows_for(uniq), codes)

        key = (snap_gen, n, l, k, tuple(pressure_checks), str(torch.device(device)))
        entry = holder.get("predicates")
        if entry is None or entry["key"] != key or len(entry["index"]) > 16384:
            entry = {"key": key, "index": {}, "buffer": None}
            holder["predicates"] = entry
        sig_bytes = [uniq[i].tobytes() for i in range(uniq.shape[0])]
        missing = [i for i, b in enumerate(sig_bytes) if b not in entry["index"]]
        if missing:
            new_rows = rows_for(uniq[missing])
            base = 0 if entry["buffer"] is None else entry["buffer"].shape[0]
            for off, i in enumerate(missing):
                entry["index"][sig_bytes[i]] = base + off
            entry["buffer"] = (
                new_rows if entry["buffer"] is None
                else torch.cat([entry["buffer"], new_rows], dim=0)
            )
        rows_idx = np.asarray([entry["index"][b] for b in sig_bytes], dtype=np.int64)
        return gather(entry["buffer"], rows_idx[codes])


def signature_codes(st):
    """``(codes [T], uniq uint8 [S, L + K + 1])``: one byte row per distinct
    (selector, tolerations, unknown-flag) row of the session's tasks,
    ``codes`` mapping each task to its row."""
    from scheduler_tpu_torch.api.job_info import unique_row_codes

    t = st.tasks.count
    sig_inputs = np.concatenate(
        [
            st.tasks.selector[:t],
            st.tasks.tolerated[:t],
            st.tasks.has_unknown_selector[:t, None],
        ],
        axis=1,
    ).astype(np.uint8)
    return unique_row_codes(sig_inputs)


def signature_rows(st):
    """The static-predicate kernel's task-side operands at signature width:
    ``(codes [T], selector [S, L], unknown [S], tolerated [S, K])``, one row
    per distinct (selector, tolerations, unknown-flag) byte row of the
    session's tasks, ``codes`` mapping each task to its row."""
    codes, uniq = signature_codes(st)
    return (codes,) + split_signatures(
        uniq, st.tasks.selector.shape[1], st.tasks.tolerated.shape[1])


def split_signatures(uniq, l, k):
    """Signature byte rows -> ``(selector [S, L], unknown [S], tolerated
    [S, K])`` as bool."""
    sub = uniq.astype(bool)
    return sub[:, :l], sub[:, l + k], sub[:, l : l + k]


def _affinity_only_pod(pod: PodSpec) -> PodSpec:
    """View of the pod with only affinity (selector already on the device mask)."""
    clone = PodSpec(name=pod.name, namespace=pod.namespace)
    clone.affinity = pod.affinity
    return clone


def new(arguments: Arguments) -> PredicatesPlugin:
    return PredicatesPlugin(arguments)
