"""scheduler_tpu_torch: the batch scheduler's PyTorch/CUDA port.

The package mirrors ``scheduler_tpu``'s module layout (``apis``, ``api``,
``cache``, ``framework``, ``actions``, ``plugins``, ``ops``, ``harness``) so
that each module's counterpart sits at the same path.  The host framework is
plain Python and numpy; the device engine (``ops``) keeps its state in torch
tensors, and the allocate action's whole greedy loop runs as one hand-written
CUDA kernel (``csrc/mega_allocate.cu``, bound in ``ops/megakernel.py``).

The package imports ``torch`` and ``numpy`` and never ``jax`` or any module
of ``scheduler_tpu``.  Entry points take a ``device`` argument that defaults
to CUDA and raise when no GPU is present; tests pass ``device="cpu"``, where
each kernel wrapper runs its plain PyTorch version.
"""
