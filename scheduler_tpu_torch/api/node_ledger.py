"""Columnar node ledger: the cluster's dynamic node state as [N, R] matrices.

Columnar replacement for the reference's per-node accounting structs
(``pkg/scheduler/api/node_info.go:24-60`` — Idle/Used/Releasing Resource
pointers chased per node).  Here the cache owns ONE ledger whose rows are the
nodes; each ``NodeInfo``'s ``idle``/``used``/``releasing`` vectors are row
VIEWS (``_LedgerVec``), so:

* per-node ``ResourceVec`` arithmetic writes straight through to the matrix;
* a session snapshot of all node state is three matrix copies, not 3xN
  vector clones (``snapshot``, cache.go:584-654 NewClusterInfo equivalent);
* the engine's snapshot tensors (``api/tensors.py``) gather rows instead of
  walking 10k objects;
* the bulk commit applies node deltas as one scatter, not N dict lookups.

Ownership: every matrix belongs to exactly one owner (the cache, or one
session's clone).  ``clone()`` copies the matrices and FREEZES the row space
(its ``row_of``/``names`` are snapshots); only the cache-owned ledger attaches
or detaches rows.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Optional

import numpy as np

from scheduler_tpu_torch.api.resource import ResourceVec
from scheduler_tpu_torch.api.vocab import ResourceVocabulary


class _LedgerVec(ResourceVec):
    """A ResourceVec whose storage is one row of a ledger matrix.

    Never caches the row across ops: ``_sync`` re-slices from the ledger, so
    capacity growth (matrix reallocation) and vocabulary widening are both
    transparent.  ``has_scalars`` lives in the ledger's per-row flag arrays so
    it survives re-materialization of the wrapper objects.
    """

    __slots__ = ("_ledger", "_mat", "_row")

    def __init__(self, vocab: ResourceVocabulary, ledger: "NodeLedger", mat: str, row: int) -> None:
        self.vocab = vocab
        self._ledger = ledger
        self._mat = mat
        self._row = row
        self.max_task_num = 0
        self._arr = getattr(ledger, mat)[row]

    def _sync(self) -> None:
        led = self._ledger
        if led.r < self.vocab.size:
            led.widen(self.vocab.size)
        self._arr = getattr(led, self._mat)[self._row]

    # ``milli_cpu``/``memory`` read self._arr without _sync in the base class
    # (hot-path micro-opt there); a view must re-slice first.
    @property
    def milli_cpu(self) -> float:
        self._sync()
        return float(self._arr[0])

    @property
    def memory(self) -> float:
        self._sync()
        return float(self._arr[1])

    @property
    def has_scalars(self) -> bool:
        return bool(self._ledger.scalar_flags[self._mat][self._row])

    @has_scalars.setter
    def has_scalars(self, value: bool) -> None:
        self._ledger.scalar_flags[self._mat][self._row] = bool(value)


_DYNAMIC = ("idle", "releasing", "used")


class NodeLedger:
    """Columnar dynamic node state + mirrored statics (allocatable, ready).

    ``gen`` bumps on any row-space or width change (attach/detach/widen) —
    consumers memoize derived orderings against it.
    """

    def __init__(self, r: int, cap: int = 8) -> None:
        self.r = r
        self.n = 0  # high-water row count (freed rows stay below n)
        self.idle = np.zeros((cap, r))
        self.releasing = np.zeros((cap, r))
        self.used = np.zeros((cap, r))
        self.allocatable = np.zeros((cap, r))
        self.task_count = np.zeros(cap, dtype=np.int64)
        self.max_tasks = np.zeros(cap, dtype=np.int64)
        self.ready = np.zeros(cap, dtype=bool)
        self.scalar_flags: Dict[str, np.ndarray] = {
            m: np.zeros(cap, dtype=bool) for m in _DYNAMIC
        }
        # Map-presence flag of each node's ALLOCATABLE ("ScalarResources !=
        # nil" survives explicit zeros) — the column-sum fast paths must OR
        # these exactly like the object path ORs allocatable.has_scalars.
        self.alloc_scalars = np.zeros(cap, dtype=bool)
        self.names: List[Optional[str]] = []
        self.row_of: Dict[str, int] = {}
        self._free: List[int] = []
        self.gen = 0
        self._order: Optional[np.ndarray] = None
        self._order_gen = -1

    # -- row management (cache-owned ledgers only) ---------------------------

    def _grow(self, cap: int) -> None:
        for mat in ("idle", "releasing", "used", "allocatable"):
            old = getattr(self, mat)
            new = np.zeros((cap, old.shape[1]))
            new[: old.shape[0]] = old
            setattr(self, mat, new)
        for arr_name in ("task_count", "max_tasks", "ready"):
            old = getattr(self, arr_name)
            new = np.zeros(cap, dtype=old.dtype)
            new[: old.shape[0]] = old
            setattr(self, arr_name, new)
        for m, old in self.scalar_flags.items():
            new = np.zeros(cap, dtype=bool)
            new[: old.shape[0]] = old
            self.scalar_flags[m] = new
        old = self.alloc_scalars
        self.alloc_scalars = np.zeros(cap, dtype=bool)
        self.alloc_scalars[: old.shape[0]] = old

    def widen(self, r: int) -> None:
        """Vocabulary registered new scalars: grow the R axis."""
        if r <= self.r:
            return
        for mat in ("idle", "releasing", "used", "allocatable"):
            old = getattr(self, mat)
            new = np.zeros((old.shape[0], r))
            new[:, : old.shape[1]] = old
            setattr(self, mat, new)
        self.r = r
        self.gen += 1

    def attach(self, name: str) -> int:
        """Assign a (zeroed) row to a node name."""
        row = self.row_of.get(name)
        if row is not None:
            return row
        if self._free:
            row = self._free.pop()
            self.names[row] = name
            self._zero_row(row)
        else:
            row = self.n
            if row == self.idle.shape[0]:
                self._grow(max(16, 2 * row))
            self.n = row + 1
            self.names.append(name)
        self.row_of[name] = row
        self.gen += 1
        return row

    def detach(self, name: str) -> None:
        row = self.row_of.pop(name, None)
        if row is None:
            return
        self.names[row] = None
        self._zero_row(row)
        self._free.append(row)
        self.gen += 1

    def _zero_row(self, row: int) -> None:
        self.idle[row] = 0.0
        self.releasing[row] = 0.0
        self.used[row] = 0.0
        self.allocatable[row] = 0.0
        self.task_count[row] = 0
        self.max_tasks[row] = 0
        self.ready[row] = False
        self.alloc_scalars[row] = False
        for flags in self.scalar_flags.values():
            flags[row] = False

    # -- derived views --------------------------------------------------------

    def sorted_rows(self) -> np.ndarray:
        """Row indices of live nodes in sorted-name order (the engines' node
        axis order), memoized per generation."""
        if self._order_gen != self.gen:
            pairs = sorted(self.row_of.items())
            self._order = np.asarray([row for _, row in pairs], dtype=np.int64)
            self._order_gen = self.gen
        return self._order

    def sorted_names(self) -> List[str]:
        rows = self.sorted_rows()  # ensures memo freshness
        return [self.names[int(r)] for r in rows]

    def total_allocatable(self) -> np.ndarray:
        """[R] sum of live nodes' allocatable (placeholder rows are zero)."""
        return self.allocatable[: self.n].sum(axis=0)

    def total_used(self) -> np.ndarray:
        return self.used[: self.n].sum(axis=0)

    def apply_node_deltas(
        self,
        rows: np.ndarray,        # i64 [K] ledger rows (unique)
        idle_sub: np.ndarray,    # f64 [K, R]
        rel_sub: np.ndarray,     # f64 [K, R]
        used_add: np.ndarray,    # f64 [K, R]
        count_add: np.ndarray,   # i64 [K] task-count increments
        mins: np.ndarray,        # [R] epsilon thresholds
    ) -> None:
        """The bulk commit's node arithmetic as THREE fancy-index ops —
        exactly ``NodeInfo.add_deferred_batches``'s agg accounting
        (idle -= alloc rows, releasing -= pipelined rows, used += both,
        task_count += placements) folded over every touched node at once.
        The epsilon-tolerant sufficiency check ALWAYS evaluates, like the
        per-node ``sub_array`` it replaces — ``assert_that`` decides
        log-vs-raise (PANIC_ON_ERROR)."""
        from scheduler_tpu_torch.utils.assertions import assert_that

        # The delta width is the CALLER's vocab size, which can outrun this
        # ledger's R: the vocabulary is append-only and grows when a pod
        # introduces a new scalar resource — no node event widens the cache
        # ledger.  Widen here so a session-vocab-wide commit never hits a
        # broadcast error mid-apply.
        if idle_sub.shape[1] > self.r:
            self.widen(idle_sub.shape[1])
        r = idle_sub.shape[1]
        m = mins[:r][None, :]
        cur_i = self.idle[rows][:, :r]
        cur_r = self.releasing[rows][:, :r]
        assert_that(
            bool(
                np.all((idle_sub < cur_i) | (np.abs(cur_i - idle_sub) < m))
                and np.all((rel_sub < cur_r) | (np.abs(cur_r - rel_sub) < m))
            ),
            "resource is not sufficient for bulk node delta",
        )
        self.idle[rows, :r] -= idle_sub
        self.releasing[rows, :r] -= rel_sub
        self.used[rows, :r] += used_add
        self.task_count[rows] += count_add
        if used_add.shape[1] > 2:
            touched = np.any(used_add[:, 2:] != 0.0, axis=1)
            if touched.any():
                flags = self.scalar_flags["used"]
                flags[rows[touched]] = True

    def any_alloc_scalars(self) -> bool:
        """OR of allocatable map-presence flags — what the object path's
        per-node ``add(node.allocatable)`` would leave in has_scalars."""
        return bool(self.alloc_scalars[: self.n].any())

    def any_used_scalars(self) -> bool:
        return bool(self.scalar_flags["used"][: self.n].any())

    # -- snapshot -------------------------------------------------------------

    def clone(self) -> "NodeLedger":
        """Deep-copy the matrices, snapshot the row space (session isolation)."""
        led = NodeLedger.__new__(NodeLedger)
        led.r = self.r
        led.n = self.n
        led.idle = self.idle.copy()
        led.releasing = self.releasing.copy()
        led.used = self.used.copy()
        led.allocatable = self.allocatable.copy()
        led.task_count = self.task_count.copy()
        led.max_tasks = self.max_tasks.copy()
        led.ready = self.ready.copy()
        led.scalar_flags = {m: f.copy() for m, f in self.scalar_flags.items()}
        led.alloc_scalars = self.alloc_scalars.copy()
        led.names = list(self.names)
        led.row_of = dict(self.row_of)
        led._free = list(self._free)
        led.gen = self.gen
        led._order = self._order
        led._order_gen = self._order_gen
        return led


class LedgerNodeMap(Mapping):
    """The session's node map: a CLONED ledger plus lazy per-node views.

    Replaces the eager 10k-object node clone of the snapshot path
    (cache.go:584-654): dynamic state is isolated by the ledger matrix copy
    up front; a ``NodeInfo`` view over it materializes only when host-path
    code actually touches that node (statement rollback, victim sweeps,
    host predicates, tests).  The device engines read ``.ledger`` directly.

    Construction runs under the cache mutex: ``captures`` holds each node's
    bookkeeping snapshot taken there, so later materialization never races
    cache mutation.
    """

    def __init__(self, ledger: "NodeLedger", sources: Dict[str, object], captures: Dict[str, tuple]) -> None:
        self.ledger = ledger
        self._sources = sources
        self._captures = captures
        self._views: Dict[str, object] = {}
        # Deferred columnar batch RECORDS for nodes nobody materialized: the
        # vectorized bulk commit applies the ledger arithmetic wholesale and
        # stashes each node's (cores, status) records here; a later
        # materialization folds them into the view's lazy task map.
        self._stashed_batches: Dict[str, list] = {}

    def __getitem__(self, name: str):
        view = self._views.get(name)
        if view is None:
            from scheduler_tpu_torch.api.node_info import NodeInfo

            src = self._sources[name]
            view = NodeInfo.view_for_snapshot(src, self.ledger, self._captures[name])
            stashed = self._stashed_batches.pop(name, None)
            if stashed:
                view.append_batch_records(stashed)
            self._views[name] = view
        return view

    def node_spec(self, name: str):
        """The captured node spec WITHOUT materializing a view (the object
        path's ``node is not None`` accounting guard needs it)."""
        view = self._views.get(name)
        if view is not None:
            return view.node
        return self._captures[name][5]

    def stash_batch_records(self, name: str, batches) -> None:
        """Record (cores, status) batches WITHOUT materializing the node —
        ledger arithmetic must already be applied (apply_node_deltas)."""
        view = self._views.get(name)
        if view is not None:
            view.append_batch_records(batches)
        else:
            self._stashed_batches.setdefault(name, []).extend(batches)

    def __contains__(self, name) -> bool:
        return name in self._sources

    def __iter__(self):
        return iter(self._sources)

    def __len__(self) -> int:
        return len(self._sources)
