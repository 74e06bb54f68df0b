"""The node mesh: the fused engine's node axis split into blocks over a
device list, driven by one controller.

The node axis is the engines' big axis: node tensors (the [N, R] ledgers,
the [S, N] static rows) split into contiguous blocks, one a shard; job,
queue and task tensors stay whole.  This is the JAX package's
``scheduler_tpu/ops/mesh.py`` in the JAX single-controller model (one
process over N devices): a "sharded" tensor is a ``Sharded``, a list of
per-device blocks, and the merge across shards (the winner of a step, the
LP iteration's row stats) is a read of D small candidate rows by the host
or the first device, never a collective between processes.

Specs (``--mesh`` daemon flag / ``SCHEDULER_TORCH_MESH``, the twin of
``SCHEDULER_TPU_MESH``):

* ``N`` or ``auto``: a 1-D ``(nodes,)`` mesh over the first power-of-two
  devices of the list.
* ``RxC`` (e.g. ``2x4``): a 2-D ``(replica, nodes)`` mesh of R * C shards
  in replica-major order (shard ``r * C + c``), the order the JAX package
  computes when ``jax.process_count()`` is 1.  Both factors powers of two.

``1`` (the default) keeps one device.  Malformed or oversized specs, and a
node bucket smaller than the mesh, stay on one device with the JAX
package's warnings.  The device list is the CUDA devices of the process
(``torch.cuda``), or what ``set_mesh_devices`` gave: a list may repeat a
device (``[cuda:0] * 4`` puts four shards on one card; ``[cpu] * 8`` is the
tests' counterpart of ``--xla_force_host_platform_device_count=8``).  A mesh
across processes and hosts (``torch.distributed``) is not carried:
``processes`` is always 1.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("scheduler_tpu_torch.ops.mesh")

NODE_AXIS = "nodes"
REPLICA_AXIS = "replica"

_cached_mesh = None
_cached_key: Optional[str] = None
_devices: Optional[List[torch.device]] = None

_MESH_2D_RE = re.compile(r"^(\d+)x(\d+)$")

# Spec values that mean "no mesh" (shared with mesh_requested()).
_OFF_SPECS = ("", "1", "none", "off", "0")


def _indexed(d) -> torch.device:
    """``d`` as a device with its index (``cuda`` is the current card), so
    that it compares equal to the device of a tensor placed there."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class NodeMesh:
    """A node mesh: ``devices`` (one a shard, replica-major), ``shape``
    (``{"nodes": D}`` or ``{"replica": R, "nodes": C}``), ``axis_names``
    and ``size``."""

    def __init__(self, devices: Sequence[torch.device], shape: dict) -> None:
        self.devices = tuple(_indexed(d) for d in devices)
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} devices, got "
                             f"{len(self.devices)}")

    @property
    def first(self) -> torch.device:
        """The device of shard 0, where replicated operands lie and the merge
        runs."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"NodeMesh({self.shape}, {[str(d) for d in self.devices]})"


class Sharded:
    """A node-family tensor split into ``mesh.size`` equal blocks along
    ``axis`` (0: node-major, 1: node-trailing): ``shards[k]`` is shard k's
    block, on ``mesh.devices[k]``, holding global rows ``[k * n_local, (k + 1)
    * n_local)``.  ``family`` is its registry family (``ops/layout.py``
    SHARDING, the 2-D twin on a 2-D mesh)."""

    def __init__(self, mesh: NodeMesh, shards: Sequence[torch.Tensor], axis: int,
                 family: str) -> None:
        self.mesh = mesh
        self.shards = list(shards)
        self.axis = axis
        self.family = family
        first = self.shards[0]
        self.n_local = int(first.shape[axis])
        shape = list(first.shape)
        shape[axis] = self.n_local * len(self.shards)
        self.shape = torch.Size(shape)
        self.dtype = first.dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, gathered on ``device`` (default: the first
        shard's)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards], dim=self.axis)

    @classmethod
    def split(cls, mesh: NodeMesh, a: torch.Tensor, axis: int, family: str) -> "Sharded":
        """``a`` split into the mesh's blocks along ``axis``, block k moved to
        ``mesh.devices[k]``."""
        n_local = a.shape[axis] // mesh.size
        shards = [a.narrow(axis, k * n_local, n_local).to(dev).contiguous()
                  for k, dev in enumerate(mesh.devices)]
        return cls(mesh, shards, axis, family)


def mesh_spec() -> str:
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_MESH", "1")


def mesh_requested(spec: Optional[str] = None) -> bool:
    """True when the spec asks for a mesh (even one that later degrades)."""
    if spec is None:
        spec = mesh_spec()
    return spec.strip().lower() not in _OFF_SPECS


def parse_2d_spec(spec: str) -> Optional[Tuple[int, int]]:
    """``(R, C)`` for a valid 2-D spec (both factors powers of two, product
    > 1), else None."""
    m = _MESH_2D_RE.match(spec.strip().lower())
    if not m:
        return None
    r, c = int(m.group(1)), int(m.group(2))

    def pow2(v):
        return v >= 1 and (v & (v - 1)) == 0

    if not (pow2(r) and pow2(c)) or r * c < 2:
        return None
    return r, c


def _pow2_floor(want: int, limit: int) -> int:
    n = 1
    while n * 2 <= min(want, limit):
        n *= 2
    return n


def set_mesh_devices(devices: Optional[Sequence]) -> None:
    """Set the device list ``get_mesh`` draws from (``None``: the process's
    CUDA devices again) and clear its memo.  A list may repeat a device."""
    global _devices, _cached_mesh, _cached_key
    _devices = None if devices is None else [_indexed(d) for d in devices]
    _cached_mesh, _cached_key = None, None


def mesh_devices() -> List[torch.device]:
    """The device list ``get_mesh`` draws from."""
    if _devices is not None:
        return list(_devices)
    if not torch.cuda.is_available():
        return []
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def get_mesh() -> Optional[NodeMesh]:
    """The configured node mesh (1-D or 2-D), or None for one device (the
    default).  Malformed and oversized specs stay on one device with a
    warning; memoized on the spec string (``set_mesh_devices`` clears it)."""
    global _cached_mesh, _cached_key
    spec = mesh_spec().strip().lower()
    if spec == _cached_key:
        return _cached_mesh
    mesh = None
    if spec not in _OFF_SPECS:
        devices = mesh_devices()
        if _MESH_2D_RE.match(spec):
            parsed = parse_2d_spec(spec)
            if parsed is None:
                logger.warning("malformed 2-D mesh spec %r (powers-of-two factors, "
                               "product > 1); staying single-chip", spec)
            elif parsed[0] * parsed[1] > len(devices):
                logger.warning("mesh %r needs %d devices but only %d available; "
                               "staying single-chip", spec, parsed[0] * parsed[1],
                               len(devices))
            else:
                r, c = parsed
                mesh = NodeMesh(devices[: r * c], {REPLICA_AXIS: r, NODE_AXIS: c})
        else:
            if spec == "auto":
                want = len(devices)
            else:
                try:
                    want = int(spec)
                except ValueError:
                    logger.warning("malformed mesh spec %r; staying single-chip", spec)
                    want = 1
            n = _pow2_floor(want, len(devices))
            if n > 1:
                mesh = NodeMesh(devices[:n], {NODE_AXIS: n})
            elif want > 1:
                logger.warning("mesh %r requested but only %d device(s); staying "
                               "single-chip", spec, len(devices))
    _cached_mesh, _cached_key = mesh, spec
    return mesh


def mesh_topology(mesh=None) -> dict:
    """Topology record of the active regime (``mesh=None``: the configured
    mesh): spec, devices, processes (always 1) and the axes map."""
    if mesh is None:
        mesh = get_mesh()
    axes = {str(k): int(v) for k, v in mesh.shape.items()} if mesh is not None else {}
    return {
        "spec": mesh_spec(),
        "devices": int(mesh.size) if mesh is not None else 1,
        "processes": 1,
        "axes": axes,
    }


def topology_key(mesh=None) -> Optional[tuple]:
    """Hashable topology identity for the engine-cache key: device count,
    process count and the ordered (axis name, size) pairs; ``None`` without
    a mesh.  ``auto`` resolves to whatever the device list holds, so the
    spec string alone cannot be the identity."""
    if mesh is None:
        mesh = get_mesh()
    if mesh is None:
        return None
    return (int(mesh.size), 1, tuple((str(k), int(v)) for k, v in mesh.shape.items()))


def is_multi_host(mesh) -> bool:
    """True for the 2-D ``(replica, nodes)`` mesh."""
    return REPLICA_AXIS in mesh.axis_names


def family_on(mesh, fam: str) -> str:
    """A 1-D family's name on ``mesh``: its 2-D twin on a 2-D mesh."""
    from scheduler_tpu_torch.ops.layout import SHARD_FAMILY_2D

    return SHARD_FAMILY_2D[fam] if is_multi_host(mesh) else fam


def shard_fused_args(mesh: NodeMesh, args: Tuple) -> Tuple:
    """Place ``fused_allocate``'s operands on the mesh by the registry's
    ``FUSED_ARG_FAMILIES``: node-major device tensors split on their rows,
    [S, N] static rows on their node axis, everything else whole on the
    mesh's first device.  Host operands (numpy arrays: the loop's own
    ledgers) stay on the host; the arms read their shard's rows.  A node
    bucket that does not divide the mesh stays single-device with a
    warning."""
    from scheduler_tpu_torch.ops.layout import FUSED_ARG_FAMILIES

    n_bucket = args[0].shape[0]
    if n_bucket % mesh.size != 0:
        logger.warning("node bucket %d smaller than the %d-chip mesh; staying single-chip",
                       n_bucket, mesh.size)
        return args

    def place(i, a):
        if not isinstance(a, torch.Tensor):
            return a
        fam = FUSED_ARG_FAMILIES[i] if i < len(FUSED_ARG_FAMILIES) else "replicated"
        if fam == "node_trailing" and not (a.ndim == 2 and a.shape[1] > 1):
            fam = "replicated"
        if fam == "replicated":
            return a.to(mesh.first)
        axis = 0 if fam == "node_major" else 1
        return Sharded.split(mesh, a, axis, family_on(mesh, fam))

    return tuple(place(i, a) for i, a in enumerate(args))
