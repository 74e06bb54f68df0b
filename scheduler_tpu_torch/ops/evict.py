"""The victim hunt's shared rules for preempt/reclaim, host-walk half
(``scheduler_tpu/ops/evict.py:84-160``, ``:962-988``).

The reference's victim hunt is a per-node Python pipeline — enumerate the
node's Running tasks, clone them, run the tiered victim dispatch per
candidate, heap-sort the survivors, evict a sufficiency prefix
(``preempt.go:180-260``, ``reclaim.go:134-195``).  The actions
(``actions/preempt.py``, ``actions/reclaim.py``) run that walk, pre-gated
by ``ops/victims.py``.  This module holds what the walk shares:

* ``enabled_victim_fns``: the victim plugins registered and tier-enabled,
  in dispatch order;
* ``FloorGuard``: the live gang floor — one hunt's sufficiency prefix never
  strands a cohort below ``min_member``;
* the ``evict`` evidence note (``note_evidence``).

The JAX package's batched victim-plan engine (``EvictEngine``, behind
``SCHEDULER_TPU_EVICT=device``, off by default) is not ported yet: the
port's hunt is the host walk, the JAX package's default, and its evidence
reads ``flavor host``.
"""

from __future__ import annotations

from typing import Dict, Optional


def evict_flavor() -> str:
    """The victim-hunt flavor: ``host``, the reference per-node walk (the
    JAX package's default; its ``device`` flavor is not ported)."""
    return "host"


def enabled_victim_fns(ssn, kind: str) -> tuple:
    """(plugin name, plugin object) pairs whose victim fn is registered AND
    tier-enabled, in dispatch order, one tuple a tier — THE single source
    for the host path's FloorGuard applicability."""
    enabled_key = (
        "preemptable_enabled" if kind == "preempt" else "reclaimable_enabled"
    )
    registry = ssn.preemptable_fns if kind == "preempt" else ssn.reclaimable_fns
    out = []
    for tier in ssn.tiers:
        tier_list = []
        for plugin in tier.plugins:
            if getattr(plugin, enabled_key)() and plugin.name in registry:
                tier_list.append((plugin.name, plugin))
        out.append(tuple(tier_list))
    return tuple(out)


class FloorGuard:
    """The live gang floor, host-hunt side: re-applies the gang plugin's own
    formula per ACCEPTED victim with a locally-decremented ready count, so a
    single hunt's sufficiency prefix can never strand a cohort below
    ``min_member`` (the JAX package's device plan applies the identical
    ``k <= occupied - min_available`` rule).

    Counts are LOCAL (captured at first sight, decremented per take) — the
    preempt loop's interleaved ``stmt.evict`` calls already decrement the
    session's ready counts, and reading them live would double-count.
    ``None`` when gang is not an enabled victim fn for the kind: sessions
    without gang must not grow a floor the dispatch never imposed."""

    def __init__(self, ssn) -> None:
        self.ssn = ssn
        self._room: Dict[str, Optional[int]] = {}

    @classmethod
    def for_session(cls, ssn, kind: str) -> Optional["FloorGuard"]:
        for tier_list in enabled_victim_fns(ssn, kind):
            for name, _ in tier_list:
                if name == "gang":
                    return cls(ssn)
        return None

    def take(self, victim) -> bool:
        """True when evicting ``victim`` keeps its job at/above the floor
        (and books the eviction); False skips the victim."""
        job = self.ssn.jobs.get(victim.job)
        if job is None:
            return True
        room = self._room.get(victim.job)
        if room is None:
            if job.min_available == 1:
                self._room[victim.job] = room = -1  # unlimited, gang's carve-out
            else:
                self._room[victim.job] = room = (
                    job.ready_task_num() - job.min_available
                )
        if room < 0:
            return True
        if room == 0:
            return False
        self._room[victim.job] = room - 1
        return True


def host_stats(kind: str) -> dict:
    """The ``evict`` evidence block of an action that ran the host walk:
    the JAX package's record for its default flavor."""
    return {"flavor": evict_flavor(), "kind": kind, "engaged": False,
            "reason": "flavor host"}


def note_evidence(kind: str, stats: dict) -> None:
    """Merge one action's evict evidence into the cycle's ``evict`` note
    (preempt and reclaim both run per cycle; the note carries both)."""
    from scheduler_tpu_torch.utils import phases

    if not phases.active():
        return
    cur = dict(phases.get_note("evict") or {})
    cur[kind] = stats
    phases.note("evict", cur)
