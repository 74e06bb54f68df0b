"""Device engine: the allocate action's snapshot tensors, the fused
allocator host shim (``fused``) and the mega kernel (``megakernel``)."""
