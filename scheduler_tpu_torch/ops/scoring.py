"""Node scoring (the reference's nodeorder plugin on the device), in PyTorch.

The copy of ``scheduler_tpu/ops/scoring.py`` that the ``fused_allocate``
loop's XLA step arm (``ops/xla_step.py``) scores with.  The two
resource-driven k8s priorities read the live idle matrix:

* least_requested: score = mean over cpu, memory of
  (capacity - requested) / capacity, times 10: favours empty nodes;
* balanced_allocation: 10 - |cpu_fraction - memory_fraction| * 10:
  penalises lopsided usage;
* binpack: the mean requested fraction over cpu, memory, times 10: favours
  full nodes.

Each operation of the JAX functions is one PyTorch operation here, in the
same order and in float32 (``requested = allocatable - idle + req`` left to
right, the two-element mean as ``(a + b) / 2``, a weighted term as a product
and then a sum): no operation is fused with another, so the bits are the
JAX package's wherever its compiler does not contract a product into a sum.
"""

from __future__ import annotations

import torch

from scheduler_tpu_torch.api.vocab import CPU, MEMORY


def _requested_and_safe(req, idle, allocatable):
    requested = allocatable - idle + req[None, :]
    safe_alloc = torch.where(allocatable > 0, allocatable, 1.0)
    return requested, safe_alloc


def _least_requested(requested, safe_alloc, allocatable):
    frac = torch.clamp((allocatable - requested) / safe_alloc, 0.0, 1.0)
    return ((frac[:, CPU] + frac[:, MEMORY]) / 2.0) * 10.0


def _balanced(requested, safe_alloc):
    frac = torch.clamp(requested / safe_alloc, 0.0, 1.0)
    diff = (frac[:, CPU] - frac[:, MEMORY]).abs()
    return (1.0 - diff) * 10.0


def _binpack(requested, safe_alloc):
    frac = torch.clamp(requested / safe_alloc, 0.0, 1.0)
    return ((frac[:, CPU] + frac[:, MEMORY]) / 2.0) * 10.0


def least_requested_score(req, idle, allocatable):
    """req [R], idle [N, R], allocatable [N, R] -> score [N] in [0, 10]."""
    return _least_requested(*_requested_and_safe(req, idle, allocatable), allocatable)


def balanced_allocation_score(req, idle, allocatable):
    """req [R], idle [N, R], allocatable [N, R] -> score [N] in [0, 10]."""
    return _balanced(*_requested_and_safe(req, idle, allocatable))


def binpack_score(req, idle, allocatable):
    """MostRequested-style packing score [N]: favours fuller nodes."""
    return _binpack(*_requested_and_safe(req, idle, allocatable))


def dynamic_score(req, idle, allocatable, least_requested_weight: float,
                  balanced_weight: float, binpack_weight: float, safe_alloc=None):
    """Weighted sum of the idle-dependent scorers, f32 [N]; a weight of 0
    leaves its scorer out, as the JAX function does at trace time.  Every
    scorer's ``requested`` and ``safe_alloc`` are the same values, so they
    are computed once (``safe_alloc`` may come precomputed from the
    caller, a function of ``allocatable`` alone)."""
    score = torch.zeros(idle.shape[0], dtype=torch.float32, device=idle.device)
    if not (least_requested_weight or balanced_weight or binpack_weight):
        return score
    requested = allocatable - idle + req[None, :]
    if safe_alloc is None:
        safe_alloc = torch.where(allocatable > 0, allocatable, 1.0)
    if least_requested_weight:
        score = score + least_requested_weight * _least_requested(requested, safe_alloc,
                                                                  allocatable)
    if balanced_weight:
        score = score + balanced_weight * _balanced(requested, safe_alloc)
    if binpack_weight:
        score = score + binpack_weight * _binpack(requested, safe_alloc)
    return score
