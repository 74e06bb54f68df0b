"""Device engine: the allocate action's snapshot tensors, the fused
allocator host shim (``fused``), the mega kernel (``megakernel``), the
static-predicate kernel (``predicate_kernel``) and the one build of their
CUDA sources (``cuda_build``)."""
