"""Host↔device transfer policy: padding, unit scaling, dtypes.

Numerics: device tensors are float32.
Raw byte quantities (~4e11 per node) would push float32's absolute error past
the reference's 10 MiB epsilon once summed across a big cluster, so the memory
column is rescaled to MiB on device — epsilon comparisons are invariant under a
per-dimension rescale applied to both operands and thresholds, and per-node
magnitudes (~1e5 MiB) keep absolute error << the 10 MiB epsilon.  Cluster-wide
sums only feed share ratios (DRF/proportion), where relative error is what
matters and float32 is ample.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from scheduler_tpu_torch.api.vocab import MEMORY, ResourceVocabulary

MIB = 1024.0 * 1024.0


class DevicePolicy:
    """Per-vocabulary scaling and padding rules for device tensors."""

    def __init__(self, vocab: ResourceVocabulary) -> None:
        self.vocab = vocab

    def column_scale(self, r: Optional[int] = None) -> np.ndarray:
        """[R] multiplier taking canonical host units to device units."""
        r = r if r is not None else self.vocab.size
        scale = np.ones(r, dtype=np.float64)
        if r > MEMORY:
            scale[MEMORY] = 1.0 / MIB
        return scale

    def scaled_mins(self, r: Optional[int] = None) -> np.ndarray:
        r = r if r is not None else self.vocab.size
        mins = np.ones(r, dtype=np.float64)
        vocab_mins = self.vocab.min_thresholds()
        mins[: vocab_mins.shape[0]] = vocab_mins
        return mins * self.column_scale(r)


def scale_columns(mat: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Apply per-dimension unit scaling: [*, R] * [R]."""
    return (mat * scale[None, :]).astype(np.float32)


def pad_rows(mat: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis to ``rows`` (a bucket size) with ``fill``."""
    n = mat.shape[0]
    if n == rows:
        return mat
    pad_shape = (rows - n,) + mat.shape[1:]
    return np.concatenate([mat, np.full(pad_shape, fill, dtype=mat.dtype)], axis=0)


def resolve_device(device=None):
    """The torch device an entry point runs on: ``None`` means CUDA.  A CUDA
    device without a GPU raises — the engines never carry on on the CPU
    unless the caller asks for it (``device="cpu"``, as the tests do)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
