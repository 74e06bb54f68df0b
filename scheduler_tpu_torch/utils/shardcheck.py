"""``SCHEDULER_TORCH_SHARDCHECK=1``: the runtime check of the sharding
registry (``ops/layout.py`` SHARDING / FUSED_ARG_FAMILIES), the twin of the
JAX package's ``SCHEDULER_TPU_SHARDCHECK``.

At dispatch and readback every operand's placement is held to the family
its position declares:

* a host operand (a numpy array: the loop's own ledgers) is never placed:
  always consistent;
* a whole tensor is replicated, and on a mesh it must lie on the mesh's
  first device (where one controller runs the replicated work); it is
  consistent with every family (the whole-loop kernel runs replicated by
  design, and a bucket that does not divide the mesh stays whole);
* a ``mesh.Sharded`` must carry the family's name on this mesh (its 2-D
  twin on a 2-D mesh), belong to this mesh, have shard k on
  ``mesh.devices[k]`` and hold its n / D rows along the family's axis.
  Without a mesh nothing may be sharded.

The failure is silent otherwise: a misplaced block still computes (the
shard arms move what they read) but the one-read-a-step contract breaks.
Violations are counted (``violations()``) and reported through
``utils/assertions.assert_that``: a loud log by default, a raise under
``PANIC_ON_ERROR``.  Off, every entry point costs one flag read.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_violation_log: list = []


def enabled() -> bool:
    from scheduler_tpu_torch.utils.envflags import env_bool

    return env_bool("SCHEDULER_TORCH_SHARDCHECK", False)


def violations() -> int:
    return len(_violation_log)


def reset() -> None:
    _violation_log.clear()


def _record(where: str, what: str, msg: str) -> None:
    from scheduler_tpu_torch.utils.assertions import assert_that

    _violation_log.append({"where": where, "what": what, "msg": msg})
    assert_that(False, f"shardcheck[{where}] {what}: {msg}")


def _check_one(a, fam: str, mesh, where: str, what: str) -> None:
    from scheduler_tpu_torch.ops.layout import SHARDING
    from scheduler_tpu_torch.ops.mesh import Sharded, family_on

    if isinstance(a, Sharded):
        if mesh is None:
            _record(where, what, "sharded over a mesh, but the engine has none")
            return
        want = family_on(mesh, fam)
        if a.family != want:
            _record(where, what, f"family '{a.family}' does not match the registry's '{want}' "
                                 f"{SHARDING[want]} on this mesh (ops/layout.py SHARDING)")
            return
        if a.mesh is not mesh or len(a.shards) != mesh.size:
            _record(where, what, f"{len(a.shards)} shards of another mesh")
            return
        n_local = a.shape[a.axis] // mesh.size
        for k, (block, dev) in enumerate(zip(a.shards, mesh.devices)):
            if block.device != dev:
                _record(where, what, f"shard {k} lies on {block.device}, not {dev}")
                return
            if block.shape[a.axis] != n_local:
                _record(where, what, f"shard {k} holds {block.shape[a.axis]} rows, not "
                                     f"{n_local}")
                return
        return
    if mesh is not None and isinstance(a, torch.Tensor) and a.device != mesh.first:
        _record(where, what, f"a replicated tensor on {a.device}, not on the mesh's first "
                             f"device {mesh.first}")


def check_dispatch(mesh, args: Sequence, families: Optional[Sequence[str]] = None,
                   where: str = "dispatch") -> None:
    """Hold a launch's operands to the registry: ``families`` None reads
    ``FUSED_ARG_FAMILIES`` (positions past it replicated); ``()`` holds every
    operand as replicated (the whole-loop kernel's)."""
    if not enabled():
        return
    if families is None:
        from scheduler_tpu_torch.ops.layout import FUSED_ARG_FAMILIES

        families = FUSED_ARG_FAMILIES
    for i, a in enumerate(args):
        fam = families[i] if i < len(families) else "replicated"
        _check_one(a, fam, mesh, where, f"arg[{i}]")


def check_result(mesh, dev, where: str = "readback") -> None:
    """The codes and the evidence are per-task values: they come back whole
    (on the first device, or on the host where the loop wrote them), never
    sharded."""
    from scheduler_tpu_torch.ops.mesh import Sharded

    if not enabled() or dev is None:
        return
    if isinstance(dev, Sharded):
        _record(where, "result", f"a result sharded as '{dev.family}'")
