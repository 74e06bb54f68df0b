"""Selection with the node axis split over a node mesh (``ops/mesh.py``).

The JAX package's ``scheduler_tpu/ops/sharded.py`` in the port's
single-controller model.  Each shard owns a contiguous block of the node
tensors, and a step's selection is a two-level argmax:

  local:  fit + score + argmax over the shard's block      (on its device)
  global: the D candidate rows (score, global index, extra lanes) read by
          the host and merged there                      (D small rows)

Only the winning shard's rows change.  Ties go to the lowest shard and,
inside a shard, to the lowest local row: the lowest global index, the
single-device argmax's rule.  The merges here are compares only (no float
arithmetic), so a merged result is bitwise the single-device one; the LP
iteration's row-stat merge (``merge_row_logsumexp``) is the one merge that
sums.

``sharded_place_scan`` and ``sharded_selector_mask`` are the JAX package's
mesh scan and mask, which no production path calls (its tests hold them);
the engines' mesh arms are ``ops/fused.py::_K1MeshArm`` and
``ops/xla_step.py::XlaShardStep``.  The shard index of a block is its
replica-major linear index, ``shard_linear_index``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from scheduler_tpu_torch.ops.layout import LP_PACK, WINNER
from scheduler_tpu_torch.ops.mesh import (
    NODE_AXIS,
    REPLICA_AXIS,
    NodeMesh,
    Sharded,
    family_on,
    is_multi_host,
)
from scheduler_tpu_torch.ops.predicates import fit_mask, selector_mask
from scheduler_tpu_torch.ops.scoring import dynamic_score

__all__ = [
    "NODE_AXIS", "REPLICA_AXIS", "is_multi_host", "node_shard_axes", "shard_linear_index",
    "two_level_winner", "two_level_winner_with_capacity", "two_level_winner_with_queue",
    "merge_row_logsumexp", "sharded_place_scan", "sharded_selector_mask",
]


def node_shard_axes(mesh: NodeMesh) -> Tuple[str, ...]:
    """The axes node rows split over: ``(replica, nodes)`` on the 2-D mesh,
    ``(nodes,)`` on the 1-D one."""
    return (REPLICA_AXIS, NODE_AXIS) if is_multi_host(mesh) else (NODE_AXIS,)


def shard_linear_index(mesh: NodeMesh, replica: int, node: int) -> int:
    """Replica-major linear index of the shard at ``(replica, node)`` (on the
    1-D mesh ``replica`` is 0): its position in ``mesh.devices`` and the
    block of global rows it owns."""
    if is_multi_host(mesh):
        return replica * mesh.shape[NODE_AXIS] + node
    if replica:
        raise ValueError("a 1-D mesh has no replica axis")
    return node


def two_level_winner(cands: Sequence[Sequence]) -> Tuple:
    """The winning candidate of D rows ``(score, global index, *extra)``, one
    a shard in shard order: the largest score, the first shard on ties.
    Indices and counts stay Python ints."""
    best = 0
    for k in range(1, len(cands)):
        if cands[k][WINNER.SCORE] > cands[best][WINNER.SCORE]:
            best = k
    return tuple(cands[best])


def two_level_winner_with_capacity(cands: Sequence[Sequence]):
    """``(score, global index, capacity, pod room)`` of the winning shard's
    row ``(score, index, cap, pods)``."""
    win = two_level_winner(cands)
    return win[WINNER.SCORE], int(win[WINNER.INDEX]), int(win[WINNER.CAP]), \
        int(win[WINNER.PODS])


def two_level_winner_with_queue(cands: Sequence[Sequence]):
    """``(score, global index, capacity, pod room, queue id)``: rows carry the
    selected job's queue id as a fifth lane."""
    win = two_level_winner(cands)
    return (win[WINNER.SCORE], int(win[WINNER.INDEX]), int(win[WINNER.CAP]),
            int(win[WINNER.PODS]), int(win[WINNER.QUEUE]))


def merge_row_logsumexp(packs: torch.Tensor):
    """The LP iteration's cross-block row-stat merge: ``packs`` f32 [D, 4, T]
    (``LP_PACK`` rows of each block, in shard order) -> ``(m, s, pref,
    upd_max)``.  ``m`` the max of the blocks' row maxima; ``s = sum_d s_d *
    exp(m_d - m)`` added in shard order; ``pref`` the ARGMAX lane of the
    first block holding ``m``; ``upd_max`` the max of the UPD lanes."""
    m_d = packs[:, LP_PACK.MAX, :]
    m = m_d.max(dim=0).values
    s = torch.zeros_like(m)
    for d in range(packs.shape[0]):
        s = s + packs[d, LP_PACK.SUM] * torch.exp(m_d[d] - m)
    star = torch.argmax(m_d, dim=0)
    pref = packs[:, LP_PACK.ARGMAX, :].gather(0, star[None, :])[0]
    upd_max = packs[:, LP_PACK.UPD, 0].max()
    return m, s, pref, upd_max


def _blocks(mesh: NodeMesh, a, axis: int) -> List[torch.Tensor]:
    if isinstance(a, Sharded):
        return a.shards
    fam = "node_major" if axis == 0 else "node_trailing"
    return Sharded.split(mesh, a, axis, family_on(mesh, fam)).shards


def sharded_place_scan(idle, releasing, task_count, allocatable, pods_limit, mins,
                       init_resreq, resreq, static_mask, static_score, valid, ready_deficit,
                       *, mesh: NodeMesh, weights: Tuple[float, float, float],
                       enforce_pod_count: bool):
    """``ops/placement._place_scan``'s contract with the node axis split over
    ``mesh`` (node operands whole or ``Sharded``): a step a task, each
    shard's candidate ``(score, global index, fit idle, fit releasing)``
    merged by ``two_level_winner``, the owning shard's rows updated.
    Returns ``(idle, releasing, task_count, chosen, pipelined, failed)``,
    the node tensors as ``Sharded`` copies, the rest whole on the first
    device."""
    fam = family_on(mesh, "node_major")
    idle_b = [b.clone() for b in _blocks(mesh, idle, 0)]
    rel_b = [b.clone() for b in _blocks(mesh, releasing, 0)]
    tc_b = [b.clone() for b in _blocks(mesh, task_count, 0)]
    alloc_b = _blocks(mesh, allocatable, 0)
    plim_b = _blocks(mesh, pods_limit, 0)
    smask_b = _blocks(mesh, static_mask, 1)
    sscore_b = _blocks(mesh, static_score, 1)
    n_local = idle_b[0].shape[0]
    d = mesh.size
    t = int(valid.shape[0])
    valid_l = valid.tolist()
    deficit = int(ready_deficit)
    rows = [[(init_resreq[i].to(dev), resreq[i].to(dev)) for dev in mesh.devices]
            for i in range(t)]
    mins_b = [mins.to(dev) for dev in mesh.devices]
    neg_inf = float("-inf")
    chosen = [-1] * t
    pipelined = [False] * t
    failed = [False] * t
    n_alloc, stopped = 0, False
    for i in range(t):
        cands = []
        for k in range(d):
            init_req, req = rows[i][k]
            fit_idle = fit_mask(init_req, idle_b[k], mins_b[k])
            fit_rel = fit_mask(init_req, rel_b[k], mins_b[k])
            feasible = (fit_idle | fit_rel) & smask_b[k][i]
            if enforce_pod_count:
                feasible = feasible & (tc_b[k] < plim_b[k])
            score = sscore_b[k][i] + dynamic_score(req, idle_b[k], alloc_b[k], *weights)
            masked = torch.where(feasible, score, neg_inf)
            lbest = int(torch.argmax(masked))
            cands.append((float(masked[lbest]), lbest + k * n_local,
                          bool(fit_idle[lbest]), bool(fit_rel[lbest])))
        win = two_level_winner(cands)
        any_feasible = win[WINNER.SCORE] > neg_inf
        active = (not stopped) and valid_l[i]
        placed = active and any_feasible
        alloc_here = placed and win[WINNER.FIT_IDLE]
        pipe_here = placed and not win[WINNER.FIT_IDLE] and win[WINNER.FIT_REL]
        if alloc_here or pipe_here:
            k, row = divmod(win[WINNER.INDEX], n_local)
            req = rows[i][k][1]
            if alloc_here:
                idle_b[k][row] -= req
            else:
                rel_b[k][row] -= req
            tc_b[k][row] += 1
            chosen[i] = win[WINNER.INDEX]
        n_alloc += int(alloc_here)
        failed[i] = active and not any_feasible
        pipelined[i] = pipe_here
        became_ready = (alloc_here or pipe_here) and n_alloc >= deficit
        stopped = stopped or failed[i] or became_ready
    first = mesh.first
    return (Sharded(mesh, idle_b, 0, fam), Sharded(mesh, rel_b, 0, fam),
            Sharded(mesh, tc_b, 0, fam),
            torch.tensor(chosen, dtype=torch.int32, device=first),
            torch.tensor(pipelined, dtype=torch.bool, device=first),
            torch.tensor(failed, dtype=torch.bool, device=first))


def sharded_selector_mask(task_selector: torch.Tensor, node_labels, *,
                          mesh: NodeMesh) -> Sharded:
    """The session-static label-selector mask, a block a shard: each shard's
    [T, n_local] rows from its block of the node labels, laid out as the
    scan's node-trailing rows.  No merge."""
    blocks = [selector_mask(task_selector.to(b.device), b)
              for b in _blocks(mesh, node_labels, 0)]
    return Sharded(mesh, blocks, 1, family_on(mesh, "node_trailing"))
