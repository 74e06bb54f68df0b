"""Steady-state cycle measurement (the JAX package's ``harness/measure.py``
protocol, ``scheduler_tpu/harness/measure.py:20-93``).

In a running scheduler the cache mirrors the cluster between cycles and the
engine built by the previous cycle stays resident (``ops/engine_cache.py``).
A freshly built synthetic cluster would charge that one-time build to the
measured cycle, so ``steady_cycle`` first builds the engine once through the
engine cache without placing anything (``warm_engine``), then times one
open -> actions -> close cycle with the garbage collector frozen: that cycle
hits the resident engine.  ``timed_cycle`` times a cycle as it comes
(churned work is cold in a steady scheduler too).

The JAX module's ``link_probe`` measures its TPU link and has no
counterpart here.
"""

from __future__ import annotations

import gc
import time


def _sync(device) -> None:
    """Wait for the device's queued work, so a cycle's time includes it."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_cycle_phases(cache, conf, actions, device=None) -> tuple:
    """Run and time one scheduling cycle with the garbage collector frozen.

    Returns ``(elapsed, phases)``: ``phases`` is the cycle's split (open,
    engine_init, overlap_host, dispatch, device, decode, apply, close and
    whatever else the actions time, ``utils/phases.py``) with the cycle's
    uploads (``uploads``, ``upload_bytes``: the transfer cache's misses;
    ``upload_hits``) and, under ``notes``, the cycle's annotations (the
    engine cache's outcome, the ``dirty`` evidence, the engine's)."""
    from scheduler_tpu_torch.framework import close_session, get_action, open_session
    from scheduler_tpu_torch.ops import transfer_cache
    from scheduler_tpu_torch.utils import phases

    gc.collect()
    gc.freeze()
    transfer_cache.reset_counters()
    phases.begin()
    try:
        start = time.perf_counter()
        with phases.phase("open"):
            ssn = open_session(cache, conf.tiers, device=device)
        for name in actions:
            get_action(name).execute(ssn)
        with phases.phase("close"):
            close_session(ssn)
        _sync(device)
        elapsed = time.perf_counter() - start
    finally:
        gc.unfreeze()
        notes = phases.take_notes()
        rec = phases.end()
    xfer = transfer_cache.reset_counters()
    rec["uploads"] = xfer["misses"]
    rec["upload_bytes"] = xfer["miss_bytes"]
    rec["upload_hits"] = xfer["hits"]
    rec["notes"] = notes
    return elapsed, rec


def timed_cycle(cache, conf, actions, device=None) -> float:
    return timed_cycle_phases(cache, conf, actions, device)[0]


def warm_engine(cache, conf, device=None) -> None:
    """Build the engine once through the engine cache without placing
    anything, so that the next cycle's allocate finds it resident (the
    steady scheduler's state between cycles)."""
    from scheduler_tpu_torch.actions.allocate import collect_candidates
    from scheduler_tpu_torch.framework import close_session, open_session
    from scheduler_tpu_torch.ops import engine_cache
    from scheduler_tpu_torch.ops.fused import FusedAllocator

    warm_ssn = open_session(cache, conf.tiers, device=device)
    cands = collect_candidates(warm_ssn)
    if cands and warm_ssn.nodes and FusedAllocator.supported(warm_ssn, cands):
        engine_cache.get_engine(warm_ssn, cands)
    close_session(warm_ssn)
    _sync(device)


def steady_cycle(cache, conf, actions, device=None) -> float:
    """Warm the engine, then run and time one scheduling cycle (seconds)."""
    warm_engine(cache, conf, device)
    return timed_cycle(cache, conf, actions, device)


def steady_cycle_phases(cache, conf, actions, device=None) -> tuple:
    """``steady_cycle`` with the phase split (see ``timed_cycle_phases``)."""
    warm_engine(cache, conf, device)
    return timed_cycle_phases(cache, conf, actions, device)
