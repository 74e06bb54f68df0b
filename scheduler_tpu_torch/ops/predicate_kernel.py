"""The static-predicate mask as ONE CUDA kernel launch.

This replaces ``scheduler_tpu/ops/pallas_kernels.py:292``
``static_predicate_mask`` (a Pallas TPU kernel).  The kernel source is
``csrc/static_predicate_mask.cu``; it packs the bool operands 32 entries a
word itself (no pre-pass, no other host representation).  It is built with
the port's other kernels at first use (``ops/cuda_build.py``) and bound
through a plain C entry point with ``ctypes``.

* ``static_predicate_mask`` — the wrapper.  CUDA tensors launch the kernel
  on the current stream (or raise); CPU tensors run
  ``static_predicate_mask_reference``.  Each launch adds one to
  ``launches``.
* ``static_predicate_mask_reference`` — the plain PyTorch version:
  ``plugin_predicate_mask(...) & taint_mask(...)`` of ``ops/predicates.py``,
  float32 products with TF32 off.

``mask[s, n] = (sel[s]·!labels[n] + !tolerated[s]·taints[n] == 0)
& !unknown[s] & !unsched[n]`` — every input a bool tensor, the result a bool
``[S, N]`` tensor on the inputs' device.
"""

from __future__ import annotations

import ctypes

import torch

from scheduler_tpu_torch.ops import cuda_build
from scheduler_tpu_torch.ops.predicates import plugin_predicate_mask, taint_mask

# Launches of the CUDA kernel (the CPU path never counts).
launches = 0

# Signatures a block of the kernel (its grid's y axis).
_TILE_S = 64
_MAX_GRID_Y = 65535


def static_predicate_mask_reference(selector, has_unknown, node_labels, unschedulable,
                                    node_taints, tolerated) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the inputs' device."""
    return plugin_predicate_mask(selector, has_unknown, node_labels, unschedulable) & taint_mask(
        node_taints, tolerated
    )


def static_predicate_mask(selector: torch.Tensor, has_unknown: torch.Tensor,
                          node_labels: torch.Tensor, unschedulable: torch.Tensor,
                          node_taints: torch.Tensor, tolerated: torch.Tensor) -> torch.Tensor:
    """Fused selector + taint + gate mask -> bool [S, N].

    ``selector`` bool [S, L] required label pairs, ``has_unknown`` bool [S]
    (a selector pair no node has), ``node_labels`` bool [N, L],
    ``unschedulable`` bool [N], ``node_taints`` bool [N, K], ``tolerated``
    bool [S, K].  With no task or no node the mask is all true and nothing
    is launched."""
    s, l = selector.shape
    n, k = node_taints.shape
    dev = selector.device
    cuda = dev.type == "cuda"
    tensors = (("selector", selector, (s, l)), ("has_unknown", has_unknown, (s,)),
               ("node_labels", node_labels, (n, l)), ("unschedulable", unschedulable, (n,)),
               ("node_taints", node_taints, (n, k)), ("tolerated", tolerated, (s, k)))
    for name, t, shape in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if t.dtype != torch.bool:
            raise ValueError(f"{name}: expected torch.bool, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if cuda and not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if s == 0 or n == 0:
        return torch.ones((s, n), dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return static_predicate_mask_reference(selector, has_unknown, node_labels, unschedulable,
                                               node_taints, tolerated)
    if not cuda:
        raise ValueError(f"static_predicate_mask: no kernel for device {dev}")
    if -(-s // _TILE_S) > _MAX_GRID_Y:
        raise ValueError(f"static_predicate_mask: {s} task rows exceed the launch grid")
    return _launch(selector, has_unknown, node_labels, unschedulable, node_taints, tolerated)


_fn = None


def _entry():
    """The kernel's C entry point, its argument types set once."""
    global _fn
    if _fn is None:
        fn = cuda_build.load().static_predicate_mask_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(selector, has_unknown, node_labels, unschedulable, node_taints, tolerated):
    global launches
    s, l = selector.shape
    n, k = node_taints.shape
    fn = _entry()
    out = selector.new_empty(s, n)  # bool, on the selector's device
    stream = torch._C._cuda_getCurrentRawStream(selector.device.index)  # the current stream
    rc = fn(selector.data_ptr(), has_unknown.data_ptr(), node_labels.data_ptr(),
            unschedulable.data_ptr(), node_taints.data_ptr(), tolerated.data_ptr(),
            out.data_ptr(), s, n, l, k, stream)
    if rc != 0:
        raise RuntimeError(f"static_predicate_mask launch failed: CUDA error {rc}")
    launches += 1
    return out
