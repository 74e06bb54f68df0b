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


class LP_STATS:
    """The LP relaxation's evidence row (``ops/lp_place.py``, i32[2]),
    decoded by ``lp_place.lp_stats_dict`` into the ``lp`` block of
    ``FusedAllocator.run_stats()``."""

    ITERATIONS = 0    # fixed-point iterations run (always the knob)
    CONVERGED_AT = 1  # first iteration whose projection update fell under
                      # SCHEDULER_TORCH_LP_TOL (-1: never)


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


class WINNER:
    """The two-level winner tuple (``ops/sharded.py``): one candidate row a
    node shard, read back by the host and merged there.  Lanes 2..3 are the
    per-site extra lanes: capacity and pod room on the cohort path, the fit
    bits on the plain scan path."""

    SCORE = 0
    INDEX = 1
    CAP = 2        # cohort capacity count (two_level_winner_with_capacity)
    PODS = 3       # pod-count room of the winning node
    QUEUE = 4      # selected job's queue id (two_level_winner_with_queue)
    FIT_IDLE = 2   # alias of CAP: plain-scan extra lane 0 (idle-fit bit)
    FIT_REL = 3    # alias of PODS: plain-scan extra lane 1 (releasing-fit bit)


class LP_PACK:
    """The LP iteration's row-stat pack (f32 [4, T] a node block,
    ``ops/lp_place.py`` -> ``sharded.merge_row_logsumexp``): the one tensor
    merged across blocks an iteration, the LP twin of ``WINNER``."""

    MAX = 0      # the block's row max (streaming logsumexp)
    SUM = 1      # the block's sum of exponentials at its row max
    ARGMAX = 2   # the block's best node, as a GLOBAL index (f32-exact)
    UPD = 3      # the block's previous projection-update max, along the row


class EVICT_PICK:
    """The eviction pick's candidate tuple (``ops/evict.py``
    ``sharded_victim_pick``): one row a node shard, the winner the earliest
    sweep-order position."""

    POS = 0    # sweep-order position of the shard's best node (+inf: none)
    NODE = 1   # that node's GLOBAL row index, as f32 (exact below 2^24)


# -- the sharding registry (ops/mesh.py, utils/shardcheck.py) -----------------
#
# The node mesh (``ops/mesh.py``) splits the fused engine's node axis into
# blocks, one a shard, in replica-major order on the 2-D spec.  A buffer of a
# node family is a ``mesh.Sharded`` (shard k's block on the mesh's device k);
# a replicated buffer lies whole on the mesh's first device (one controller
# runs every shard, so "replicated" means "once, where the merge runs").

# The mesh axes (``sharded.NODE_AXIS`` / ``sharded.REPLICA_AXIS``).
SHARD_AXES = {"NODE_AXIS": "nodes", "REPLICA_AXIS": "replica"}

# Buffer families -> the axis split of each dimension (None: whole; a tuple
# splits that dimension over the combined axes, replica-major).
SHARDING = {
    "node_major": ("nodes",),
    "node_trailing": (None, "nodes"),
    "node_major_2d": (("replica", "nodes"),),
    "node_trailing_2d": (None, ("replica", "nodes")),
    "replicated": (),
}

# 1-D family -> its 2-D twin, applied by the staging and the check alike.
SHARD_FAMILY_2D = {
    "node_major": "node_major_2d",
    "node_trailing": "node_trailing_2d",
    "replicated": "replicated",
}

# The sites that merge across shards and what each reads back an iteration
# or a step: exactly one gather of the shards' candidate tuples (a host read
# of D small rows; the LP pack's merge runs on the first device), never a
# node ledger.  The whole-loop kernel, the water-fill and the selector mask
# read nothing across shards.
COLLECTIVE_BUDGET = {
    "ops/fused.py::_K1MeshArm.step": {"gather": 1},
    "ops/xla_step.py::XlaShardStep.step": {"gather": 1},
    "ops/sharded.py::sharded_place_scan": {"gather": 1},
    "ops/sharded.py::sharded_selector_mask": {"gather": 0},
    "ops/lp_place.py::lp_iterate_blocks": {"gather": 1},
    "ops/evict.py::sharded_victim_pick": {"gather": 1},
    "ops/backfill.py::sharded_backfill_fill": {"gather": 1},
    "ops/megakernel.py::mega_allocate": {"gather": 0},
    "ops/qfair.py::qfair_solve": {"gather": 0},
}

# ``fused_allocate``'s positional operand families (``ops/fused.py``
# FUSED_OPERAND_NAMES): the one row the staging (``mesh.shard_fused_args``)
# and the check (``utils/shardcheck.py``) both read.  Positions past it are
# replicated.  The node_trailing entries degrade to replicated for [*, 1]
# dummies (no static rows): a unit axis cannot split.
FUSED_ARG_FAMILIES = (
    "node_major",      # idle [N, R]
    "node_major",      # releasing [N, R]
    "node_major",      # task_count [N]
    "node_major",      # allocatable [N, R]
    "node_major",      # pods_limit [N]
    "node_major",      # node_gate [N]
    "replicated",      # mins [R]
    "replicated",      # init_resreq [T, R]
    "replicated",      # resreq [T, R]
    "node_trailing",   # static_mask [S, N]
    "node_trailing",   # static_score [S, N]
)
