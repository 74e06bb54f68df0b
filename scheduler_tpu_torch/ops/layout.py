"""Row layouts of the kernels' scratch, stats and request tables.

The rows this package's kernels and loop read and write, copied from
``scheduler_tpu/ops/layout.py`` with the same names and indices so that a
reader can match the CUDA source, the plain PyTorch version and the JAX
kernel row for row.
"""

from __future__ import annotations


class NODE_SCRATCH:
    """Node scratch (f32 [16|24, N], nodes on the minor axis); sessions with
    releasing capacity extend the block with the releasing ledger."""

    IDLE = 0         # span 8: live idle vector, rows 0..r_dim-1 (pad rows 0)
    TASK_COUNT = 8   # live per-node task count (pods-limit gate)
    RELEASING = 16   # span 8: live releasing ledger (pipelined placements)


class JOB_SCRATCH:
    """Job scratch (f32 [rows, J], jobs on the minor axis)."""

    CONSUMED = 0     # tasks consumed from the job's pending run
    ALLOCATED = 1    # tasks actually placed (gang-ready arithmetic)
    LEFT = 2         # nonzero once a placement failed (pop ended)
    DRF = 8          # span 8: live drf allocated per job
    QUEUE_ALLOC = 16  # span 8: live allocated of the job's QUEUE, per lane
    SHARE = 24       # maintained share of the lane's queue (delta chain)
    OVERUSED = 25    # maintained overused flag of the lane's queue
    QCOUNT = 26      # cumulative placements of the lane's queue (qfair ladder)


class STATS:
    """Evidence counters (second kernel output, i32[8])."""

    STEPS = 0             # loop steps taken
    COHORT_STEPS = 1      # steps where the cohort chunk path engaged
    CHUNK_PLACED = 2      # placements made by chunks >= 1 (multi-node wins)
    QDELTA_UPDATES = 3    # queue-share delta updates applied (delta chain)
    QFULL_RECOMPUTES = 4  # full queue-chain recomputes (the full-recompute chain)
    QFAIR_LOOKUPS = 5     # class-ladder share/overused lookups (qfair ladder)
    UNUSED = 6            # span 2: zeroed tail, reserved


STATS_WIDTH = 8


class QFAIR_STATS:
    """The queue-fair water-fill's evidence row (``ops/qfair.py``, i32[2]),
    decoded by ``qfair.qfair_stats_dict`` into proportion's evidence block."""

    ITERATIONS = 0    # water-fill rounds of the fixed budget
    CONVERGED_AT = 1  # round the host loop would have broken on (-1: the
                      # budget ran out, and proportion falls back to the host)


class JOB_STATE:
    """The ``fused_allocate`` loop's per-job state columns (``ops/fused.py``
    job_state, [J, 3 + r_dim]): the loop's twin of ``JOB_SCRATCH`` rows
    0..2 and 8..15."""

    CONSUMED = 0
    ALLOCATED = 1
    LEFT = 2
    DRF = 3    # span r_dim: drf allocated, columns 3..3+r_dim-1


class STEP_NODE:
    """The placement-step kernel's packed node state (``ops/step_kernel.py``
    ``ns``, f32 [r8 + 8, n]): the idle block is r8 = r_dim padded to 8
    rows, so the task-count row sits at ``STEP_NODE.IDLE + r8``."""

    IDLE = 0


class SIG_REQ:
    """Per-signature request table (f32 [16, S]): identical-request runs
    share one column, indexed by an i32 signature id per task."""

    REQ = 0    # span 8: resource request rows, 0..r_dim-1 live
    INIT = 8   # span 8: init (gate) request rows


def node_scratch_rows(has_releasing: bool) -> int:
    """Rows of the node scratch allocation: the idle + task-count block, and
    the releasing ledger's 8 rows where the session has releasing
    capacity."""
    return NODE_SCRATCH.RELEASING + (8 if has_releasing else 0)


def job_scratch_rows(multi_queue: bool, use_qdelta: bool) -> int:
    """Rows of the job scratch allocation (the delta rows pad to a multiple
    of 8, as in the JAX kernel)."""
    if use_qdelta:
        return -(-(JOB_SCRATCH.OVERUSED + 1) // 8) * 8
    if multi_queue:
        return JOB_SCRATCH.SHARE
    return JOB_SCRATCH.QUEUE_ALLOC


class SIG_CLASS:
    """Signature-class key columns (``ops/sig_compress.py::derive_classes``):
    the [T, 4] i64 key matrix whose unique rows define the classes that
    compress a [T, N] static mask to [S, N].  REQ_SIG is the cohort request
    signature id (``ops/megakernel.request_signature_ids``)."""

    REQ_SIG = 0     # cohort request-signature id (request + init rows)
    STATIC_SIG = 1  # per-task static-signature id (0 when no static rows)
    QUEUE = 2       # queue index of the task's job
    PRIORITY = 3    # PriorityClass value of the task's job
