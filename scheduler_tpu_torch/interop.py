"""Carrying state across from the JAX package, as plain numpy.

``mega_operands_from_numpy`` turns the staged operands and static arguments
of the JAX ``mega_allocate`` (``FusedAllocator._mega_args`` / ``_mega_kw``
there, converted to numpy by the caller) into this package's tensors, so
both kernels can run on the same inputs.  Cluster state travels as the
``{queues, nodes, podGroups, pods}`` JSON that ``cli.load_cluster_state``
reads in both packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops.megakernel import OPERAND_NAMES


def mega_operands_from_numpy(
    ops: Dict[str, np.ndarray], static: dict, device
) -> Tuple[tuple, dict]:
    """``(operands, kw)`` for ``ops.megakernel.mega_allocate``: ``ops`` maps
    every name of ``OPERAND_NAMES`` to its array, ``static`` holds the
    kernel's static arguments (a JAX-side ``interpret`` flag is dropped)."""
    missing = [name for name in OPERAND_NAMES if name not in ops]
    if missing:
        raise KeyError(f"missing mega_allocate operands: {missing}")
    dev = torch.device(device)
    operands = tuple(
        torch.from_numpy(np.array(ops[name], copy=True, order="C")).to(dev)
        for name in OPERAND_NAMES
    )
    kw = {k: v for k, v in static.items() if k != "interpret"}
    kw["weights"] = tuple(float(w) for w in kw["weights"])
    kw["mins"] = tuple(float(x) for x in kw["mins"])
    kw["comparators"] = tuple(kw["comparators"])
    return operands, kw
