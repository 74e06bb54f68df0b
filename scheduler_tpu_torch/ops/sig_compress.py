"""Signature classes: compress a [T, N] static seam to [S, N]
(``scheduler_tpu/ops/sig_compress.py:60-105``).

A class is one unique

    (request-signature, static-signature, queue, priority)

tuple (``SIG_CLASS`` column order, ``ops/layout.py``).  The request
signature is the cohort ``task_sig`` id (``ops.megakernel.
request_signature_ids``) and the static signature the per-task static id,
so the tasks of one class share their request rows and their static
``[N]`` mask rows by construction.  Backfill's device flavor
(``ops/backfill.py``) builds its class mask on these classes.  The JAX
package's ``SCHEDULER_TPU_SIG_COMPRESS`` mode, which stages the allocate
engines' static tensors and the LP relaxation on the class axis, is not
ported (neither is the LP flavor), and neither is its ``sig`` evidence
block (``sig_stats``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from scheduler_tpu_torch.ops.layout import SIG_CLASS


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
    """
    from scheduler_tpu_torch.api.job_info import unique_row_codes

    t = req_sig.shape[0]
    key_cols = np.zeros((t, 4), dtype=np.int64)
    key_cols[:, SIG_CLASS.REQ_SIG] = req_sig
    if static_sig is not None:
        key_cols[:, SIG_CLASS.STATIC_SIG] = static_sig
    key_cols[:, SIG_CLASS.QUEUE] = queue_of_task
    key_cols[:, SIG_CLASS.PRIORITY] = priority_of_task
    sig_of_task, _ = unique_row_codes(key_cols)
    class_count = np.bincount(sig_of_task).astype(np.int32)
    # First occurrence of each dense id, in id order (ids are 0..S-1).
    _, rep_rows = np.unique(sig_of_task, return_index=True)
    return sig_of_task.astype(np.int32), class_count, rep_rows.astype(np.int64)

