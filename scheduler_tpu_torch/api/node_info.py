"""Node info: per-node resource accounting and the task state machine.

Reference: ``pkg/scheduler/api/node_info.go``.  The add/remove state machine keyed
on task status (:165-222) is what makes pipelining onto releasing resources work:

* RELEASING task: counted in Releasing, subtracted from Idle, added to Used.
* PIPELINED task: subtracted from Releasing only (it consumes resources that a
  releasing task will free), not from Idle.
* any other (allocated-ish) status: subtracted from Idle, added to Used.

The per-node task map is built LAZILY.  Adds
record (frozen status, node name, source) entries and apply accounting
immediately; the frozen ``TaskInfo`` clones that ``tasks`` exposes are only
materialized when something actually walks the map (preempt/reclaim victim
sweeps, set_node rebuilds, tests).  Pure allocate/bind cycles — the hot path —
never pay the 2x100k ``clone_shared`` cost.
``task_count`` is maintained eagerly so the pod-count predicate and the node
tensors never force materialization.
"""

from __future__ import annotations

from typing import Dict, Optional

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.resource import ResourceVec
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.api.vocab import ResourceVocabulary
from scheduler_tpu_torch.apis.objects import NodeSpec


class NodeState:
    READY = "Ready"
    NOT_READY = "NotReady"


class _Pending:
    """A recorded-but-unmaterialized node task: the source task object (its
    immutable identity fields are what the frozen clone copies) plus the
    status/node frozen at add time."""

    __slots__ = ("status", "node_name", "src")

    def __init__(self, status: TaskStatus, node_name: str, src: TaskInfo) -> None:
        self.status = status
        self.node_name = node_name
        self.src = src

    def resreq(self) -> ResourceVec:
        return self.src.resreq

    def materialize(self) -> TaskInfo:
        t = self.src.clone_shared()
        t.status = self.status
        t.node_name = self.node_name
        return t


class _Batch:
    """A whole deferred columnar add: task cores (row-independent immutable
    identity objects) sharing one frozen status.  Immutable once recorded, so
    node clones share it by reference."""

    __slots__ = ("cores", "status")

    def __init__(self, cores, status: TaskStatus) -> None:
        self.cores = cores
        self.status = status


class NodeInfo:
    def __init__(self, vocab: ResourceVocabulary, node: Optional[NodeSpec] = None) -> None:
        self.vocab = vocab
        self.name: str = node.name if node else ""
        self.node: Optional[NodeSpec] = None

        self.releasing: ResourceVec = ResourceVec.empty(vocab)
        self.idle: ResourceVec = ResourceVec.empty(vocab)
        self.used: ResourceVec = ResourceVec.empty(vocab)
        self.allocatable: ResourceVec = ResourceVec.empty(vocab)
        self.capability: ResourceVec = ResourceVec.empty(vocab)

        self._tasks: Dict[str, TaskInfo] = {}
        self._pending: Dict[str, _Pending] = {}
        self._batches: list = []
        self._ledger = None
        self._row = -1
        self._tc = 0  # standalone task counter (ledger column when attached)

        self.state_phase: str = NodeState.NOT_READY
        self.state_reason: str = "UnInitialized"

        if node is not None:
            self.set_node(node)

    # -- ledger attachment (cache-owned nodes) -------------------------------

    @property
    def task_count(self) -> int:
        led = self._ledger
        if led is not None:
            return int(led.task_count[self._row])
        return self._tc

    @task_count.setter
    def task_count(self, value: int) -> None:
        led = self._ledger
        if led is not None:
            led.task_count[self._row] = value
        else:
            self._tc = value

    def attach(self, ledger) -> None:
        """Move this node's dynamic vectors into ledger rows (cache nodes).
        Current values (usually zeros — attach happens at creation) carry
        over; from here on ``idle``/``used``/``releasing`` write through."""
        from scheduler_tpu_torch.api.node_ledger import _LedgerVec

        if self.vocab.size > ledger.r:
            ledger.widen(self.vocab.size)
        row = ledger.attach(self.name)
        for mat, vec in (("idle", self.idle), ("releasing", self.releasing), ("used", self.used)):
            arr = vec.array
            getattr(ledger, mat)[row, : arr.shape[0]] = arr
            ledger.scalar_flags[mat][row] = vec.has_scalars
        alloc = self.allocatable.array
        ledger.allocatable[row, : alloc.shape[0]] = alloc
        ledger.max_tasks[row] = self.allocatable.max_task_num
        ledger.alloc_scalars[row] = self.allocatable.has_scalars
        ledger.task_count[row] = self._tc
        ledger.ready[row] = self.state_phase == NodeState.READY
        self._ledger = ledger
        self._row = row
        self.idle = _LedgerVec(self.vocab, ledger, "idle", row)
        self.releasing = _LedgerVec(self.vocab, ledger, "releasing", row)
        self.used = _LedgerVec(self.vocab, ledger, "used", row)

    @classmethod
    def view_for_snapshot(cls, src: "NodeInfo", ledger, snap) -> "NodeInfo":
        """Materialize a session-side node over a CLONED ledger: identity and
        statics shared with the source cache node, dynamic vectors as views
        into the session's own matrices, task bookkeeping from the capture
        taken under the cache mutex (``snap`` = (tasks, pending, batches))."""
        from scheduler_tpu_torch.api.node_ledger import _LedgerVec

        n = cls.__new__(cls)
        n.vocab = src.vocab
        n.name = src.name
        n.state_phase, n.state_reason = snap[3], snap[4]
        n.node, n.allocatable, n.capability = snap[5], snap[6], snap[7]
        n._ledger = ledger
        n._row = row = ledger.row_of[src.name]
        n._tc = 0
        n.idle = _LedgerVec(src.vocab, ledger, "idle", row)
        n.releasing = _LedgerVec(src.vocab, ledger, "releasing", row)
        n.used = _LedgerVec(src.vocab, ledger, "used", row)
        n._tasks = snap[0] if snap[0] is not None else {}
        n._pending = snap[1] if snap[1] is not None else {}
        n._batches = snap[2] if snap[2] is not None else []
        return n

    def snapshot_bookkeeping(self):
        """Capture bookkeeping + rebindable statics for a session
        materialization — MUST run under the owning cache's mutex (a
        mid-session ``set_node`` rebinds spec/allocatable on the source).
        Folded ``_tasks`` entries are mutated in place by eviction paths, so
        they copy eagerly; pending/batch records are immutable and copy by
        reference.  Empty bookkeeping (the common case at scale) captures as
        Nones — no dict churn."""
        statics = (self.node, self.allocatable, self.capability)
        if self._tasks or self._pending or self._batches:
            return (
                {uid: t.clone_shared() for uid, t in self._tasks.items()},
                dict(self._pending),
                list(self._batches),
                self.state_phase,
                self.state_reason,
            ) + statics
        return (None, None, None, self.state_phase, self.state_reason) + statics

    def _explode_batches(self) -> None:
        if self._batches:
            pending = self._pending
            name = self.name
            for batch in self._batches:
                status = batch.status
                for core in batch.cores:
                    pending[core.uid] = _Pending(status, name, core)
            self._batches = []

    @property
    def tasks(self) -> Dict[str, TaskInfo]:
        """The frozen per-node task map (materializes deferred adds)."""
        self._explode_batches()
        if self._pending:
            for uid, entry in self._pending.items():
                self._tasks[uid] = entry.materialize()
            self._pending.clear()
        return self._tasks

    def ready(self) -> bool:
        return self.state_phase == NodeState.READY

    def _mirror_ready(self) -> None:
        if self._ledger is not None:
            self._ledger.ready[self._row] = self.state_phase == NodeState.READY

    def _set_node_state(self, node: Optional[NodeSpec], allocatable: Optional[ResourceVec]) -> None:
        try:
            self._set_node_state_inner(node, allocatable)
        finally:
            self._mirror_ready()

    def _set_node_state_inner(self, node: Optional[NodeSpec], allocatable: Optional[ResourceVec]) -> None:
        if node is None or allocatable is None:
            self.state_phase, self.state_reason = NodeState.NOT_READY, "UnInitialized"
            return
        if node.conditions.get("Ready", "True") != "True":
            # The kubelet reported NotReady — or stopped heartbeating
            # (Ready=Unknown); the reference CheckNodeCondition requires
            # Ready == True (predicates.go:169-177).  The node keeps its
            # accounting but takes no placements — host predicates raise
            # "not ready" and the device engines drop it from the node gate,
            # both via this one phase.  A node with no conditions at all is
            # schedulable (synthetic/preloaded clusters don't report them).
            self.state_phase, self.state_reason = NodeState.NOT_READY, "NotReady"
            return
        if not self.used.less_equal(allocatable):
            # Drift between cache and cluster (OutOfSync, node_info.go:110-134).
            self.state_phase, self.state_reason = NodeState.NOT_READY, "OutOfSync"
            return
        self.state_phase, self.state_reason = NodeState.READY, ""

    def set_node(self, node: NodeSpec) -> None:
        """(Re)initialize accounting from the node object (node_info.go:137-162).

        Deliberate divergence from the reference SetNode, which neither resets
        Releasing nor special-cases pipelined tasks (so repeated node updates
        inflate Releasing there): here accounting is rebuilt as a clean fold of
        the same state machine ``add_task`` applies, keeping the two paths
        consistent by construction.
        """
        allocatable = ResourceVec.from_dict(node.allocatable, self.vocab)
        self._set_node_state(node, allocatable)
        if not self.ready():
            return

        self.name = node.name
        self.node = node
        self.allocatable = allocatable
        self.capability = ResourceVec.from_dict(node.capacity, self.vocab)
        led = self._ledger
        if led is not None:
            # Attached: reset the ledger rows in place — the view vectors
            # (and any clones' separate rows) stay bound.
            if self.vocab.size > led.r:
                led.widen(self.vocab.size)
            row = self._row
            alloc_arr = allocatable.array
            led.releasing[row] = 0.0
            led.used[row] = 0.0
            led.idle[row] = 0.0
            led.idle[row, : alloc_arr.shape[0]] = alloc_arr
            led.allocatable[row] = 0.0
            led.allocatable[row, : alloc_arr.shape[0]] = alloc_arr
            led.max_tasks[row] = allocatable.max_task_num
            led.alloc_scalars[row] = allocatable.has_scalars
            led.scalar_flags["idle"][row] = allocatable.has_scalars
            led.scalar_flags["releasing"][row] = False
            led.scalar_flags["used"][row] = False
        else:
            self.releasing = ResourceVec.empty(self.vocab)
            self.idle = allocatable.clone()
            self.used = ResourceVec.empty(self.vocab)

        for task in self.tasks.values():
            if task.status == TaskStatus.RELEASING:
                self.releasing.add(task.resreq)
                self.idle.sub(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                self.releasing.sub(task.resreq)
            else:
                self.idle.sub(task.resreq)
            self.used.add(task.resreq)

    def _account_add(self, status: TaskStatus, resreq: ResourceVec) -> None:
        if self.node is not None:
            if status == TaskStatus.RELEASING:
                self.releasing.add(resreq)
                self.idle.sub(resreq)
            elif status == TaskStatus.PIPELINED:
                self.releasing.sub(resreq)
            else:
                self.idle.sub(resreq)
            self.used.add(resreq)

    def _account_remove(self, status: TaskStatus, resreq: ResourceVec) -> None:
        if self.node is not None:
            if status == TaskStatus.RELEASING:
                self.releasing.sub(resreq)
                self.idle.add(resreq)
            elif status == TaskStatus.PIPELINED:
                self.releasing.add(resreq)
            else:
                self.idle.add(resreq)
            self.used.sub(resreq)

    def _contains(self, uid: str) -> bool:
        self._explode_batches()
        return uid in self._tasks or uid in self._pending

    def add_task(self, task: TaskInfo) -> None:
        """Account a task onto this node (node_info.go:165-196).

        The map holds a status-frozen clone so later status changes don't
        corrupt node accounting; the clone is deferred until the map is read.
        """
        if self._contains(task.uid):
            raise ValueError(f"task {task.namespace}/{task.name} already on node {self.name}")
        status = task.status
        self._account_add(status, task.resreq)
        self._pending[task.uid] = _Pending(status, task.node_name, task)
        self.task_count += 1

    def bulk_add_tasks(self, tasks, agg=None) -> None:
        """Batch ``add_task``: the same status state machine, with the resource
        arithmetic collapsed into one dense delta per accounting vector.

        Tasks must already carry their final status.  Arithmetic applies BEFORE
        any record insert so a failed sufficiency assertion leaves the node
        consistent (no half-registered batch).

        ``agg`` (CommitPlan node delta, optional):
        (idle_sub, releasing_sub, used_add, n_alloc, n_pipe) dense rows —
        skips gathering per-task rows.  Valid only for allocated/pipelined
        batches (a RELEASING task in the batch raises)."""
        if not tasks:
            return
        from scheduler_tpu_torch.api.resource import sum_rows

        if agg is not None:
            # Trusted engine batch (CommitPlan): no per-task ledger gathering.
            # ALL validation runs before any state mutates (same atomicity
            # promise as the generic path).
            releasing_status = TaskStatus.RELEASING
            entries = []
            for task in tasks:
                status = task.status
                if status is releasing_status:
                    raise ValueError("agg fast path does not cover RELEASING tasks")
                entries.append((task.uid, _Pending(status, task.node_name, task)))
            uids = {uid for uid, _ in entries}
            if len(uids) != len(entries) or any(self._contains(u) for u in uids):
                raise ValueError(f"duplicate task in bulk add on node {self.name}")
            a_idle_sub, a_rel_sub, a_used_add, n_alloc, n_pipe = agg
            if self.node is not None:
                if n_alloc:
                    self.idle.sub_array(a_idle_sub)
                if n_pipe:
                    self.releasing.sub_array(a_rel_sub)
                self.used.add_array(a_used_add)
            pending = self._pending
            for uid, entry in entries:
                pending[uid] = entry
            self.task_count += len(entries)
            return

        idle_sub = []
        rel_add = []
        rel_sub = []
        used_add = []
        entries = []
        batch_uids = set()
        for task in tasks:
            if self._contains(task.uid) or task.uid in batch_uids:
                raise ValueError(
                    f"task {task.namespace}/{task.name} already on node {self.name}"
                )
            batch_uids.add(task.uid)
            status = task.status
            if self.node is not None:
                if status == TaskStatus.RELEASING:
                    rel_add.append(task.resreq)
                    idle_sub.append(task.resreq)
                elif status == TaskStatus.PIPELINED:
                    rel_sub.append(task.resreq)
                else:
                    idle_sub.append(task.resreq)
                used_add.append(task.resreq)
            entries.append((task.uid, _Pending(status, task.node_name, task)))
        if idle_sub:
            self.idle.sub_array(sum_rows(idle_sub)[0])
        if rel_add:
            self.releasing.add_array(*sum_rows(rel_add))
        if rel_sub:
            self.releasing.sub_array(sum_rows(rel_sub)[0])
        if used_add:
            self.used.add_array(*sum_rows(used_add))
        pending = self._pending
        for uid, entry in entries:
            pending[uid] = entry
        self.task_count += len(entries)

    def append_batch_records(self, batches) -> None:
        """Record-only half of ``add_deferred_batches``: the caller already
        applied the ledger arithmetic wholesale (NodeLedger.apply_node_deltas
        covers idle/releasing/used AND task_count)."""
        append = self._batches.append
        for cores, status in batches:
            if len(cores):
                append(_Batch(cores, status))

    def add_deferred_batches(self, batches, agg) -> None:
        """Columnar batch add (trusted engine commit): no clones, no per-uid
        inserts — whole ``(cores, status)`` batch records are appended and
        explode only if the map is actually read.  ``agg`` is the CommitPlan
        node delta carrying ALL the ledger arithmetic; the engine guarantees
        batch uids are fresh (a device placement only targets PENDING tasks),
        so the object path's per-uid duplicate probe is skipped."""
        n = 0
        append = self._batches.append
        for cores, status in batches:
            if len(cores):
                append(_Batch(cores, status))
                n += len(cores)
        if not n:
            return
        a_idle_sub, a_rel_sub, a_used_add, n_alloc, n_pipe = agg
        if self.node is not None:
            if n_alloc:
                self.idle.sub_array(a_idle_sub)
            if n_pipe:
                self.releasing.sub_array(a_rel_sub)
            self.used.add_array(a_used_add)
        self.task_count += n

    def remove_task(self, ti: TaskInfo) -> None:
        self._explode_batches()
        entry = self._pending.pop(ti.uid, None)
        if entry is not None:
            self._account_remove(entry.status, entry.resreq())
            self.task_count -= 1
            return
        task = self._tasks.get(ti.uid)
        if task is None:
            raise KeyError(f"task {ti.namespace}/{ti.name} not on node {self.name}")
        self._account_remove(task.status, task.resreq)
        del self._tasks[task.uid]
        self.task_count -= 1

    def update_task(self, ti: TaskInfo) -> None:
        self.remove_task(ti)
        self.add_task(ti)

    def bulk_release_tasks(self, tis, strict: bool = True) -> None:
        """Batch -> RELEASING for tasks already accounted on this node (the
        eviction transition).  For idle-accounted entries (RUNNING etc.) the
        NET ledger effect of ``_account_remove(old) + _account_add(RELEASING)``
        is exactly ``releasing += sum(resreq)`` (idle and used cancel), applied
        as ONE dense add; entries whose recorded status is RELEASING/PIPELINED
        net differently and take the exact per-task ``update_task`` math
        (rare: a double evict or an informer race).  The recorded entries flip
        status so any later remove/update un-accounts correctly.  ~0.5ms of
        per-victim vector arithmetic becomes one array op per (node, commit)."""
        self._explode_batches()
        from scheduler_tpu_torch.api.resource import sum_rows

        reqs = []
        for ti in tis:
            entry = self._pending.get(ti.uid)
            if entry is not None:
                if entry.status in (TaskStatus.RELEASING, TaskStatus.PIPELINED):
                    if entry.status != TaskStatus.RELEASING:
                        self._account_remove(entry.status, entry.resreq())
                        self._account_add(TaskStatus.RELEASING, entry.resreq())
                else:
                    reqs.append(entry.resreq())
                self._pending[ti.uid] = _Pending(
                    TaskStatus.RELEASING, entry.node_name, entry.src
                )
                continue
            task = self._tasks.get(ti.uid)
            if task is None:
                if strict:
                    raise KeyError(
                        f"task {ti.namespace}/{ti.name} not on node {self.name}"
                    )
                continue  # cache-side guard semantics: skip unknown tasks
            if task.status in (TaskStatus.RELEASING, TaskStatus.PIPELINED):
                if task.status != TaskStatus.RELEASING:
                    self._account_remove(task.status, task.resreq)
                    self._account_add(TaskStatus.RELEASING, task.resreq)
            else:
                reqs.append(task.resreq)
            task.status = TaskStatus.RELEASING
        if reqs and self.node is not None:
            row, has_scalars = sum_rows(reqs)
            self.releasing.add_array(row, has_scalars)

    @property
    def pods_limit(self) -> int:
        return self.allocatable.max_task_num

    def clone(self) -> "NodeInfo":
        """Standalone deep clone (tests / single-node callers).  Session
        snapshots do NOT use this — they clone the ledger once and
        materialize ``view_for_snapshot`` nodes lazily."""
        n = NodeInfo.__new__(NodeInfo)
        n.vocab = self.vocab
        n.name = self.name
        n.node = self.node
        n.state_phase = self.state_phase
        n.state_reason = self.state_reason
        # allocatable/capability are never mutated in place (set_node rebinds
        # fresh vectors), so clones share them; idle/used/releasing mutate.
        n.allocatable = self.allocatable
        n.capability = self.capability
        n.releasing = self.releasing.clone()
        n.idle = self.idle.clone()
        n.used = self.used.clone()
        n._ledger = None
        n._row = -1
        n._tasks = {}
        n._pending = {}
        n._batches = []
        n.task_count = 0
        for task in self._tasks.values():
            # Folded entries are mutated in place by eviction paths (the
            # handed-out victim objects), so the clone needs its own copies;
            # deferred entries are immutable records and copy by reference.
            n._tasks[task.uid] = task.clone_shared()
        n._pending = dict(self._pending)
        n._batches = list(self._batches)
        n.task_count = self.task_count
        return n

    def __repr__(self) -> str:
        return f"Node({self.name} idle=<{self.idle}> used=<{self.used}> tasks={self.task_count})"
