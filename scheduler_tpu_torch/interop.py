"""Carrying state across from the JAX package, as plain numpy.

``mega_operands_from_numpy`` turns the staged operands and static arguments
of the JAX ``mega_allocate`` (``FusedAllocator._mega_args`` / ``_mega_kw``
there, converted to numpy by the caller) into this package's tensors, so
both kernels can run on the same inputs, in cursor and in multi-queue mode
and with releasing capacity (the queue operands ``jqueue``, ``jq_des`` and
``jq_alloc0`` and the releasing ledger ``rel0`` travel like the others);
``fused_operands_from_numpy`` does the same for the JAX ``fused_allocate``
loop (``FusedAllocator.args`` / ``_allocate_kw()``): its whole operand list,
the releasing ledger, the queue tensors, ``sig_of_task`` and the ladder's
tables included.  Cluster state travels as the ``{queues, nodes, podGroups,
pods}`` JSON that ``cli.load_cluster_state`` reads in both packages.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from scheduler_tpu_torch.ops.fused import FUSED_OPERAND_NAMES, HOST_OPERANDS
from scheduler_tpu_torch.ops.megakernel import OPERAND_NAMES

# Positional operands of the JAX ``fused_allocate``
# (scheduler_tpu/ops/fused.py:175-221): the port's loop takes the same.
JAX_FUSED_ARG_NAMES = FUSED_OPERAND_NAMES

# Static arguments of the port's loop, taken over as they are (the JAX
# ``window`` unrolling changes no result and is dropped).
_FUSED_KW = ("comparators", "queue_comparators", "overused_gate", "use_static", "n_queues",
             "weights", "enforce_pod_count", "batch_runs", "sorted_jobs", "has_releasing",
             "step_kernel", "queue_delta", "sig_compress", "qfair_ladder")


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(dev)


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
    operands = tuple(_tensor(ops[name], dev) for name in OPERAND_NAMES)
    kw = {k: v for k, v in static.items() if k != "interpret"}
    kw["weights"] = tuple(float(w) for w in kw["weights"])
    kw["mins"] = tuple(float(x) for x in kw["mins"])
    kw["comparators"] = tuple(kw["comparators"])
    return operands, kw


def fused_operands_from_numpy(
    args: Sequence[np.ndarray], kw: dict, device
) -> Tuple[tuple, dict]:
    """``(operands, kw)`` for ``ops.fused.fused_allocate`` from the JAX
    engine's loop operands (``args``, in ``JAX_FUSED_ARG_NAMES`` order) and
    static arguments (``kw``): the ``HOST_OPERANDS`` as numpy arrays, the
    rest as tensors on ``device``.  Signature-class compressed static
    tensors travel as they are, read through ``sig_of_task``.  A JAX mesh
    in ``kw`` becomes the port's mesh of the same shape over ``device``
    repeated (``ops/mesh.py``), and the operands are staged on it by
    ``mesh.shard_fused_args``."""
    from scheduler_tpu_torch.ops.mesh import NodeMesh, shard_fused_args

    if len(args) != len(JAX_FUSED_ARG_NAMES):
        raise TypeError(f"expected the {len(JAX_FUSED_ARG_NAMES)} JAX loop operands")
    named = dict(zip(JAX_FUSED_ARG_NAMES, args))
    dev = torch.device(device)
    operands = tuple(np.array(named[name], copy=True, order="C") if name in HOST_OPERANDS
                     else _tensor(named[name], dev) for name in FUSED_OPERAND_NAMES)
    port_kw = {k: kw[k] for k in _FUSED_KW}
    port_kw["weights"] = tuple(float(w) for w in port_kw["weights"])
    port_kw["comparators"] = tuple(port_kw["comparators"])
    port_kw["queue_comparators"] = tuple(port_kw["queue_comparators"])
    port_kw["mesh"] = None
    jax_mesh = kw.get("mesh")
    if jax_mesh is not None:
        shape = {str(k): int(v) for k, v in jax_mesh.shape.items()}
        mesh = NodeMesh([dev] * int(jax_mesh.size), shape)
        port_kw["mesh"] = mesh
        operands = shard_fused_args(mesh, operands)
    return operands, port_kw
