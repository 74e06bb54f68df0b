"""Signature classes: compress a [T, N] seam to [S, N]
(``scheduler_tpu/ops/sig_compress.py``).

A class is one unique

    (request-signature, static-signature, queue, priority)

tuple (``SIG_CLASS`` column order, ``ops/layout.py``).  The request
signature is the cohort ``task_sig`` id (``ops.megakernel.
request_signature_ids``) and the static signature the per-task static id,
so the tasks of one class share their request rows and their static
``[N]`` mask rows by construction.

What rides the class axis:

* the LP relaxation (``ops/lp_place.py``): it iterates over the ``[S, N]``
  class rows, each carrying ``class_count[s]`` units of mass in the
  capacity projection, and its repair reads the class rows through
  ``sig_of_task`` (``ops/fused.py``);
* backfill's device flavor (``ops/backfill.py``) builds its class mask on
  these classes.

The greedy engines of this package already read static rows by static
signature (one row a signature, ``ops/fused.py``), so under greedy the mode
changes no staging: the ``sig`` evidence block of
``FusedAllocator.run_stats()`` (``sig_stats``) reports the classes the
JAX package would stage.

``SCHEDULER_TORCH_SIG_COMPRESS`` (the twin of
``SCHEDULER_TPU_SIG_COMPRESS``): ``off``, ``on`` (even the degenerate
S == T shape) or ``auto`` (default: only when some signature repeats).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from scheduler_tpu_torch.ops.layout import SIG_CLASS


def sig_compress_mode() -> str:
    """``SCHEDULER_TORCH_SIG_COMPRESS``: ``off`` | ``on`` | ``auto``."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_SIG_COMPRESS", "auto", choices=("off", "on", "auto"))


def derive_classes(
    req_sig: np.ndarray,                  # i64 [T] cohort request-signature id
    static_sig: Optional[np.ndarray],     # i32 [T] static-signature id | None
    queue_of_task: np.ndarray,            # i32 [T]
    priority_of_task: np.ndarray,         # i32 [T]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense signature classes over the flat task axis.

    Returns ``(sig_of_task, class_count, rep_rows)``:

    * ``sig_of_task`` i32 [T] — class id per task (dense ``0..S-1``);
    * ``class_count`` i32 [S] — tasks per class;
    * ``rep_rows``    i64 [S] — one representative task row per class (its
      FIRST task in flat order), the gather index that builds the ``[S, N]``
      class rows from a per-task ``[T, N]`` build.

    ``static_sig`` is ``None`` for sessions without static rows: the column
    is zero then.

    The ids rank the key rows by their raw bytes, as the JAX package's
    ``unique_row_codes`` ranks them, without its sort of row-wide byte
    strings: each column byte-swapped to an unsigned integer compares as
    its bytes do, and only the columns that vary are sorted.
    """
    t = req_sig.shape[0]
    key_cols = np.zeros((t, 4), dtype=np.int64)
    key_cols[:, SIG_CLASS.REQ_SIG] = req_sig
    if static_sig is not None:
        key_cols[:, SIG_CLASS.STATIC_SIG] = static_sig
    key_cols[:, SIG_CLASS.QUEUE] = queue_of_task
    key_cols[:, SIG_CLASS.PRIORITY] = priority_of_task
    varying = [c for c in range(4) if t and (key_cols[:, c] != key_cols[0, c]).any()]
    keys = key_cols[:, varying].byteswap().view(np.uint64)
    # A stable sort, so the first task of each class leads its run.
    order = (np.lexsort(keys.T[::-1]) if varying else np.arange(t))
    ranked = keys[order]
    lead = np.ones(t, dtype=bool)
    lead[1:] = (ranked[1:] != ranked[:-1]).any(axis=1)
    sig_of_task = np.empty(t, dtype=np.int32)
    sig_of_task[order] = np.cumsum(lead, dtype=np.int32) - 1
    rep_rows = order[lead].astype(np.int64)
    class_count = np.diff(np.append(np.flatnonzero(lead), t)).astype(np.int32)
    return sig_of_task, class_count, rep_rows


def sig_stats(classes: int, tasks: int, bytes_saved: int) -> dict:
    """The evidence block (``FusedAllocator.run_stats()['sig']``)."""
    return {
        "classes": int(classes),
        "tasks": int(tasks),
        "compression": round(tasks / max(classes, 1), 2),
        "bytes_saved": int(bytes_saved),
    }
