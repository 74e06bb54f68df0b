"""Predicate masks: the reference's predicate stack as [T, N] booleans.

Reference behaviors covered (``plugins/predicates/predicates.go:154-299``):
node selector label matching, taints vs tolerations and the node
unschedulable gate.  Label logic is vocabulary-encoded (see
``api.tensors.LabelVocab``): "every required pair present on the node"
becomes a 0/1 matrix product whose zero entries are the passing pairs.

These are the plain PyTorch versions that the static-predicate kernel's
plain version is built from (``ops/predicate_kernel.py``).  Resource fit is
separate (``fit_mask``): it reads the live idle matrix inside the placement
scan (``ops/placement.py``), while the label and taint masks are static for
a session.  The products run
in float32 (PyTorch's default keeps TF32 off; with it on they would not
change, since 0 and 1 are exact in TF32 and the sums are accumulated in
float32): every operand is 0 or 1 and every count is below 2^24, so
``count == 0`` is exact.
"""

from __future__ import annotations

import torch


def fit_mask(req: torch.Tensor, avail: torch.Tensor, mins: torch.Tensor) -> torch.Tensor:
    """Epsilon-exact LessEqual of one request against many availability rows.

    req [R], avail [N, R], mins [R] -> bool [N].  Mirrors
    ``Resource.LessEqual`` (resource_info.go:253-276): per dim,
    req < avail or |avail - req| < min."""
    return ((req[None, :] < avail) | ((avail - req[None, :]).abs() < mins[None, :])).all(dim=-1)


def _count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[T, V] x [N, V] 0/1 operands -> f32 [T, N] counts."""
    return a.to(torch.float32) @ b.to(torch.float32).T


def selector_mask(task_selector: torch.Tensor, node_labels: torch.Tensor) -> torch.Tensor:
    """Required-label matching: [T, L] x [N, L] -> bool [T, N].  A (task,
    node) pair passes iff no required pair is missing on the node:
    violations = selector @ (1 - labels)^T; pass where violations == 0."""
    if task_selector.shape[1] == 0:
        return torch.ones((task_selector.shape[0], node_labels.shape[0]), dtype=torch.bool,
                          device=task_selector.device)
    return _count(task_selector, ~node_labels) == 0


def taint_mask(node_taints: torch.Tensor, task_tolerations: torch.Tensor) -> torch.Tensor:
    """Taint/toleration matching: [N, K] taint membership x [T, K] toleration
    membership -> bool [T, N]; a pair passes iff every taint on the node is
    tolerated: untolerated = (1 - tolerations) @ taints^T == 0."""
    if node_taints.shape[1] == 0:
        return torch.ones((task_tolerations.shape[0], node_taints.shape[0]), dtype=torch.bool,
                          device=node_taints.device)
    return _count(~task_tolerations, node_taints) == 0


def base_static_mask(n_tasks: int, node_ready: torch.Tensor) -> torch.Tensor:
    """The plugin-independent static mask -> bool [T, N]: only the node-ready
    gate.  Selector/taint/unschedulable enforcement belongs to the predicates
    *plugin* (as in the reference — without it configured, a pod's node
    selector is NOT honored), which contributes its own mask via
    ``ssn.add_device_predicate``."""
    return node_ready[None, :].expand(n_tasks, node_ready.shape[0])


def plugin_predicate_mask(
    task_selector: torch.Tensor,
    has_unknown_selector: torch.Tensor,
    node_labels: torch.Tensor,
    node_unschedulable: torch.Tensor,
) -> torch.Tensor:
    """The predicates plugin's session-static mask -> bool [T, N]: label
    selector matching + the unschedulable-node gate (predicates.go:169-231)."""
    mask = selector_mask(task_selector, node_labels)
    mask = mask & ~has_unknown_selector[:, None]
    mask = mask & ~node_unschedulable[None, :]
    return mask
