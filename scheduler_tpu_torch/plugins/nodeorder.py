"""Nodeorder plugin: soft node scoring (reference ``plugins/nodeorder/nodeorder.go``).

Arg-weighted priorities: least-requested, balanced-resource-allocation, and
preferred node affinity (``nodeaffinity.weight``/``leastrequested.weight``/
``balancedresource.weight``; defaults 1 like nodeorder.go:96-140).

Host path registers a node_order_fn computing the formulas of
``plugins/util.py``; the device path declares the least-requested/balanced
weights for the mega kernel's dynamic scorer and contributes
preferred-node-affinity as a static [T, N] score matrix — so both engines
rank nodes identically.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import Plugin
from scheduler_tpu_torch.plugins.util import balanced_allocation_host, least_requested_host

logger = logging.getLogger("scheduler_tpu_torch.plugins.nodeorder")

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"


def node_affinity_preferred_score(task: TaskInfo, node_labels: Dict[str, str]) -> float:
    aff = task.pod.affinity
    if aff is None or not aff.node_preferred:
        return 0.0
    score = 0.0
    for weight, reqs in aff.node_preferred:
        if all(r.matches(node_labels) for r in reqs):
            score += weight
    return score


HARD_POD_AFFINITY_SYMMETRIC_WEIGHT = 1.0  # v1.DefaultHardPodAffinitySymmetricWeight


def _topology_value(node: NodeInfo, key: str):
    if node.node is None:
        return None
    value = node.node.labels.get(key)
    if key == "kubernetes.io/hostname" and value is None:
        value = node.name
    return value


def _pod_matches_term(pod, term, owner_namespace: str) -> bool:
    """k8s podMatchesTermsNamespaceAndSelector: empty term namespaces mean
    the TERM OWNER's namespace; the selector matches the pod's labels."""
    namespaces = term.namespaces or [owner_namespace]
    if pod.namespace not in namespaces:
        return False
    return term.matches_labels(pod.labels)


def inter_pod_affinity_scores(ssn, task: TaskInfo, nodes, weight: float) -> Dict[str, float]:
    """The InterPodAffinity batch priority
    (reference ``nodeorder.go:229-247`` -> k8s 1.13
    ``CalculateInterPodAffinityPriority``): for every existing pod, the
    incoming pod's PREFERRED (anti-)affinity terms and — symmetrically — the
    existing pod's terms matching the incoming pod spread +-term.weight over
    every node in the matched pod's topology domain (hard affinity terms of
    existing pods count with DefaultHardPodAffinitySymmetricWeight).  Counts
    max-min normalize to 0..10, then scale by ``podaffinity.weight``.

    ``nodes`` are the CANDIDATE nodes being scored; existing pods are scanned
    over EVERY session node like the k8s mapper — a matched pod whose own
    node fails the incoming pod's predicate still boosts candidates in its
    topology domain."""
    counts: Dict[str, float] = {n.name: 0.0 for n in nodes}
    domains: Dict[str, Dict[str, list]] = {}  # key -> value -> candidate names

    def domain(key: str, value) -> list:
        if value is None:
            return ()
        per_key = domains.get(key)
        if per_key is None:
            per_key = {}
            for n in nodes:
                v = _topology_value(n, key)
                if v is not None:
                    per_key.setdefault(v, []).append(n.name)
            domains[key] = per_key
        return per_key.get(value, ())

    def spread(node: NodeInfo, key: str, w: float) -> None:
        for name in domain(key, _topology_value(node, key)):
            counts[name] += w

    in_aff = task.pod.affinity
    in_pref = list(getattr(in_aff, "pod_preferred", ()) or ()) if in_aff else []
    in_anti = list(getattr(in_aff, "pod_anti_preferred", ()) or ()) if in_aff else []
    hard_w = HARD_POD_AFFINITY_SYMMETRIC_WEIGHT

    for node in ssn.nodes.values():
        for ep in node.tasks.values():
            if ep.uid == task.uid:
                continue
            ep_pod = ep.pod
            if ep_pod is None:
                continue
            for w, term in in_pref:
                if _pod_matches_term(ep_pod, term, task.namespace):
                    spread(node, term.topology_key, float(w))
            for w, term in in_anti:
                if _pod_matches_term(ep_pod, term, task.namespace):
                    spread(node, term.topology_key, -float(w))
            ep_aff = ep_pod.affinity
            if ep_aff is None:
                continue
            if hard_w:
                for term in ep_aff.pod_affinity:
                    if _pod_matches_term(task.pod, term, ep.namespace):
                        spread(node, term.topology_key, hard_w)
            for w, term in getattr(ep_aff, "pod_preferred", ()) or ():
                if _pod_matches_term(task.pod, term, ep.namespace):
                    spread(node, term.topology_key, float(w))
            for w, term in getattr(ep_aff, "pod_anti_preferred", ()) or ():
                if _pod_matches_term(task.pod, term, ep.namespace):
                    spread(node, term.topology_key, -float(w))

    max_c = max(counts.values(), default=0.0)
    min_c = min(counts.values(), default=0.0)
    if max_c == min_c:
        return {name: 0.0 for name in counts}
    span = max_c - min_c
    return {
        name: weight * 10.0 * (c - min_c) / span for name, c in counts.items()
    }


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.w_node_affinity = arguments.get_float(NODE_AFFINITY_WEIGHT, 1.0)
        self.w_pod_affinity = arguments.get_float(POD_AFFINITY_WEIGHT, 1.0)
        self.w_least_requested = arguments.get_float(LEAST_REQUESTED_WEIGHT, 1.0)
        self.w_balanced = arguments.get_float(BALANCED_RESOURCE_WEIGHT, 1.0)

    def name(self) -> str:
        return "nodeorder"

    def on_session_open(self, ssn) -> None:
        w_lr, w_bal, w_aff = self.w_least_requested, self.w_balanced, self.w_node_affinity

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            score = 0.0
            if w_lr:
                score += w_lr * least_requested_host(task, node)
            if w_bal:
                score += w_bal * balanced_allocation_host(task, node)
            if w_aff and node.node is not None:
                score += w_aff * node_affinity_preferred_score(task, node.node.labels)
            return score

        ssn.add_node_order_fn(self.name(), node_order_fn)

        # InterPodAffinity priority (nodeorder.go:229-247), registered as a
        # batch fn ONLY when some pod in the session carries a pod-affinity
        # term: with none, every count is zero and normalization yields an
        # all-zero map (no ranking effect), so skipping registration is
        # behavior-identical — and it keeps the fused engine + sweep caches,
        # which soundly disable themselves whenever a batch fn exists.
        w_pod = self.w_pod_affinity
        if w_pod and any(job.pod_affinity_tasks for job in ssn.jobs.values()):

            def batch_node_order_fn(task: TaskInfo, nodes) -> Dict[str, float]:
                return inter_pod_affinity_scores(ssn, task, nodes, w_pod)

            ssn.add_batch_node_order_fn(self.name(), batch_node_order_fn)

        # Device: dynamic weights for idle-dependent scorers; static matrix for
        # preferred node affinity.
        ssn.device_score_weights["least_requested"] = (
            ssn.device_score_weights.get("least_requested", 0.0) + w_lr
        )
        ssn.device_score_weights["balanced"] = (
            ssn.device_score_weights.get("balanced", 0.0) + w_bal
        )
        ssn.device_weighted_plugins.add(self.name())

        if w_aff:

            def affinity_scorer(st, device):
                """Preferred-affinity [T, N] contribution on ``device``, or
                None when no task carries preferred terms — the
                overwhelmingly common cycle allocates nothing here (the
                flags come from the job stores' columnar ``pref_aff``, no
                uid->task dict is built).  Computed in numpy float32, as
                the JAX package does, then moved to the device."""
                t = st.tasks.count
                rows = (
                    np.nonzero(st.tasks.pref_aff[:t])[0]
                    if st.tasks.pref_aff.shape[0] >= t
                    else np.zeros(0, dtype=np.int64)
                )
                if rows.shape[0] == 0:
                    return None
                score = np.zeros((t, st.nodes.count), dtype=np.float32)
                node_specs = [ssn.nodes[name].node for name in st.nodes.names]
                for i in rows.tolist():
                    task = st.tasks.cores[i]
                    if task is None or task.pod.affinity is None:
                        continue
                    for j, spec in enumerate(node_specs):
                        if spec is not None:
                            score[i, j] = w_aff * node_affinity_preferred_score(
                                task, spec.labels
                            )
                return torch.from_numpy(score).to(device)

            ssn.add_device_scorer(self.name(), affinity_scorer)


def new(arguments: Arguments) -> NodeOrderPlugin:
    return NodeOrderPlugin(arguments)
