"""Host commit passes over dense arrays (numpy).

The JAX package backs these with an optional C++ library and keeps numpy
fallbacks of identical semantics; this package carries the numpy halves
only.  Result codes follow ``ops/fused.py``: >= 0 node, -1 unplaced,
-2 failed, <= -3 pipelined onto node ``-3 - code``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _as_f64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def segment_sum(rows: np.ndarray, seg: np.ndarray, num_segments: int) -> np.ndarray:
    """out[s] = sum of rows[i] where seg[i] == s; negative seg ids dropped."""
    rows = _as_f64(rows)
    seg = _as_i32(seg)
    out = np.zeros((num_segments, rows.shape[1]), dtype=np.float64)
    ok = (seg >= 0) & (seg < num_segments)
    np.add.at(out, seg[ok], rows[ok])
    return out


def segment_count(seg: np.ndarray, num_segments: int) -> np.ndarray:
    seg = _as_i32(seg)
    ok = (seg >= 0) & (seg < num_segments)
    return np.bincount(seg[ok], minlength=num_segments).astype(np.int32)


def decode_placement_codes(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Split fused result codes into (node_id, pipelined, failed, n_placed)."""
    codes = _as_i32(codes)
    alloc = codes >= 0
    pipe = codes <= -3
    node_id = np.where(alloc, codes, np.where(pipe, -3 - codes, -1)).astype(np.int32)
    return node_id, pipe, codes == -2, int(alloc.sum() + pipe.sum())


def batch_status_scatter(
    status_arrays, rows_flat: np.ndarray, offsets: np.ndarray,
    from_vals: np.ndarray, to_vals: np.ndarray, check: bool,
) -> int:
    """Write group k's new status over rows ``rows_flat[offsets[k]:offsets[k+1]]``
    of ``status_arrays[k]`` (int16).  Returns the first group whose prior
    values violated ``from_vals[k]`` when ``check`` (else -1)."""
    bad = -1
    for k in range(len(status_arrays)):
        rows = rows_flat[offsets[k]:offsets[k + 1]]
        st = status_arrays[k]
        if check and bad < 0 and not bool(np.all(st[rows] == from_vals[k])):
            bad = k
        st[rows] = to_vals[k]
    return bad
