"""Row layouts of the mega kernel's scratch, stats and request tables.

The rows this package's cursor-mode kernel reads and writes, copied from
``scheduler_tpu/ops/layout.py`` with the same names and indices so that a
reader can match the CUDA source, the plain PyTorch version and the JAX
kernel row for row.  Rows of modes this package does not carry (the
releasing ledger, the multi-queue share rows) are left out.
"""

from __future__ import annotations


class NODE_SCRATCH:
    """Node scratch (f32 [16, N], nodes on the minor axis)."""

    IDLE = 0         # span 8: live idle vector, rows 0..r_dim-1 (pad rows 0)
    TASK_COUNT = 8   # live per-node task count (pods-limit gate)
    RELEASING = 16   # end of the cursor-mode block (releasing rows not ported)


class JOB_SCRATCH:
    """Job scratch (f32 [rows, J], jobs on the minor axis)."""

    CONSUMED = 0     # tasks consumed from the job's pending run
    ALLOCATED = 1    # tasks actually placed (gang-ready arithmetic)
    LEFT = 2         # nonzero once a placement failed (pop ended)
    DRF = 8          # span 8: live drf allocated per job
    QUEUE_ALLOC = 16  # end of the cursor-mode block (queue rows not ported)


class STATS:
    """Evidence counters (second kernel output, i32[8])."""

    STEPS = 0             # loop steps taken
    COHORT_STEPS = 1      # steps where the cohort chunk path engaged
    CHUNK_PLACED = 2      # placements made by chunks >= 1 (multi-node wins)
    QDELTA_UPDATES = 3    # multi-queue delta updates (0 in cursor mode)
    QFULL_RECOMPUTES = 4  # multi-queue full recomputes (0 in cursor mode)
    QFAIR_LOOKUPS = 5     # class-ladder lookups (0 in cursor mode)
    UNUSED = 6            # span 2: zeroed tail, reserved


STATS_WIDTH = 8


class SIG_REQ:
    """Per-signature request table (f32 [16, S]): identical-request runs
    share one column, indexed by an i32 signature id per task."""

    REQ = 0    # span 8: resource request rows, 0..r_dim-1 live
    INIT = 8   # span 8: init (gate) request rows


def node_scratch_rows(has_releasing: bool) -> int:
    """Rows of the node scratch allocation.  Only the cursor-mode block is
    ported: the releasing ledger raises."""
    if has_releasing:
        raise NotImplementedError("the releasing ledger rows are not ported")
    return NODE_SCRATCH.RELEASING


def job_scratch_rows(multi_queue: bool, use_qdelta: bool) -> int:
    """Rows of the job scratch allocation.  Only the cursor-mode block is
    ported: the multi-queue rows raise."""
    if multi_queue or use_qdelta:
        raise NotImplementedError("multi-queue job scratch rows are not ported")
    return JOB_SCRATCH.QUEUE_ALLOC
