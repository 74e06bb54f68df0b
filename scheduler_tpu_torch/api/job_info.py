"""Task and Job info: the scheduler's working view of pods and gangs.

Reference: ``pkg/scheduler/api/job_info.go`` (TaskInfo :36-93, JobInfo :127-418).
The status-indexed task maps and gang arithmetic (ReadyTaskNum/ValidTaskNum/
Ready/Pipelined) are the contract the gang plugin relies on.

Columnar design: per-task MUTABLE state (status / node_name / volume_ready)
lives in per-job numpy columns (``_TaskRows``), not in Python objects.  A
``TaskInfo`` is a *view*: immutable identity fields are plain slots, mutable
fields are properties over the owning job's columns.  The payoffs:

* ``JobInfo.clone()`` (the per-cycle snapshot, reference ``cache.go:584-654``)
  copies three arrays per job instead of cloning every task object — the
  100k-task snapshot drops from O(tasks) Python to O(jobs) numpy.
* bulk status moves (the device-engine commit) are vectorized column writes
  plus O(1) count updates, with the object dict/index maintained lazily and
  only materialized for host paths that actually walk objects.
* gang arithmetic reads maintained status counts — no index walks.

State equivalence with the object model is the invariant: materializing
``tasks`` / ``task_status_index`` at any point yields exactly the dicts the
eager object implementation would hold.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from scheduler_tpu_torch.api.resource import ResourceVec
from scheduler_tpu_torch.api.types import TaskStatus, allocated_status, get_task_status
from scheduler_tpu_torch.api.unschedule_info import FitErrors
from scheduler_tpu_torch.api.vocab import ResourceVocabulary
from scheduler_tpu_torch.apis.objects import PodGroup, PodSpec
from scheduler_tpu_torch.utils.assertions import _panic_on_error

# int value -> TaskStatus object (column values decode through this).
_STATUS_OBJ: Dict[int, TaskStatus] = {int(s): s for s in TaskStatus}
# Bitmask of the allocated-ish statuses (types.ALLOCATED_STATUSES).
_ALLOC_BITS = int(
    TaskStatus.BOUND | TaskStatus.BINDING | TaskStatus.RUNNING | TaskStatus.ALLOCATED
)


def pod_resource_without_init(pod: PodSpec, vocab: ResourceVocabulary) -> ResourceVec:
    """Sum of container requests (reference GetPodResourceWithoutInitContainers)."""
    total = ResourceVec.empty(vocab)
    for c in pod.containers:
        total.add(ResourceVec.from_dict(c, vocab))
    return total


def pod_resource_request(pod: PodSpec, vocab: ResourceVocabulary) -> ResourceVec:
    """Effective request: max(sum(containers), max(init_containers))
    (reference ``pod_info.go:53-76``)."""
    total = pod_resource_without_init(pod, vocab)
    for ic in pod.init_containers:
        total.set_max(ResourceVec.from_dict(ic, vocab))
    return total


def _has_pod_affinity(pod: PodSpec) -> bool:
    """Any pod-affinity term that can CONTRIBUTE to the InterPodAffinity
    priority: preferred terms score directly, and hard AFFINITY terms act
    symmetrically with DefaultHardPodAffinitySymmetricWeight.  Hard
    ANTI-affinity is predicate-only in the k8s priority (no symmetric score),
    so counting it would forfeit the fused engine for nothing."""
    aff = pod.affinity
    return bool(
        aff is not None
        and (
            aff.pod_affinity
            or getattr(aff, "pod_preferred", None)
            or getattr(aff, "pod_anti_preferred", None)
        )
    )


def job_id_for_pod(pod: PodSpec) -> str:
    """JobID of the PodGroup a pod belongs to (reference getJobID: namespace/group)."""
    if pod.group_name:
        return f"{pod.namespace}/{pod.group_name}"
    return ""


class TaskInfo:
    """One schedulable task (pod) as seen by a Session.

    Either *detached* (``_blk is None``: status/node_name/volume_ready live in
    local slots — freshly constructed tasks, frozen node-side clones) or a
    *view* bound to a job's column block (``_blk``/``_row``: the mutable fields
    read and write the columns, so every view of a task aliases one truth).
    """

    __slots__ = (
        "uid",
        "job",
        "name",
        "namespace",
        "resreq",
        "init_resreq",
        "priority",
        "pod",
        "req_sig_cache",
        "resreq_empty_cache",
        "_blk",
        "_row",
        "_status",
        "_node_name",
        "_volume_ready",
    )

    def __init__(self, pod: PodSpec, vocab: ResourceVocabulary) -> None:
        self.uid: str = pod.uid
        self.job: str = job_id_for_pod(pod)
        self.name: str = pod.name
        self.namespace: str = pod.namespace
        self.resreq: ResourceVec = pod_resource_without_init(pod, vocab)
        self.init_resreq: ResourceVec = pod_resource_request(pod, vocab)
        self.priority: int = pod.priority
        self.pod: PodSpec = pod
        self.req_sig_cache: Optional[bytes] = None
        # Computed eagerly: views/clones inherit it, so per-cycle consumers
        # never re-run the epsilon compare (100k/cycle).
        self.resreq_empty_cache: Optional[bool] = self.resreq.is_empty()
        self._blk = None
        self._row = 0
        self._status: TaskStatus = get_task_status(pod)
        self._node_name: str = pod.node_name
        self._volume_ready: bool = False

    # -- mutable state (columns when bound, slots when detached) -------------

    @property
    def status(self) -> TaskStatus:
        blk = self._blk
        if blk is None:
            return self._status
        return _STATUS_OBJ[int(blk.status[self._row])]

    @status.setter
    def status(self, value: TaskStatus) -> None:
        blk = self._blk
        if blk is None:
            self._status = value
        else:
            blk.status[self._row] = int(value)
            blk.status_gen += 1

    @property
    def node_name(self) -> str:
        blk = self._blk
        if blk is None:
            return self._node_name
        return blk.node_name[self._row]

    @node_name.setter
    def node_name(self, value: str) -> None:
        blk = self._blk
        if blk is None:
            self._node_name = value
        else:
            blk.node_name[self._row] = value

    @property
    def volume_ready(self) -> bool:
        blk = self._blk
        if blk is None:
            return self._volume_ready
        return bool(blk.volume_ready[self._row])

    @volume_ready.setter
    def volume_ready(self, value: bool) -> None:
        blk = self._blk
        if blk is None:
            self._volume_ready = value
        else:
            blk.volume_ready[self._row] = value

    def _detach(self) -> None:
        """Freeze current column values into local slots and unbind."""
        blk = self._blk
        if blk is None:
            return
        row = self._row
        self._status = _STATUS_OBJ[int(blk.status[row])]
        self._node_name = blk.node_name[row]
        self._volume_ready = bool(blk.volume_ready[row])
        self._blk = None

    @property
    def creation_timestamp(self) -> float:
        return self.pod.creation_timestamp

    @property
    def resreq_empty(self) -> bool:
        """Cached ``resreq.is_empty()`` — request vectors are immutable after
        creation, so the answer never changes."""
        empty = self.resreq_empty_cache
        if empty is None:
            empty = self.resreq.is_empty()
            self.resreq_empty_cache = empty
        return empty

    @property
    def req_sig(self) -> bytes:
        """Byte signature of (resreq, init_resreq) — the task-order tie-break
        that groups identical requests so the device engine sees long runs.

        Bound views read the job store's matrix-derived signature when built,
        so the object sort path and ``pending_rows_sorted`` compare the SAME
        bytes (widths can otherwise differ when the vocabulary grew between
        task creations)."""
        blk = self._blk
        if blk is not None and blk.sigs is not None and blk.sig_gen == blk.gen:
            return blk.sigs[self._row]
        sig = self.req_sig_cache
        if sig is None:
            sig = self.resreq.array.tobytes() + self.init_resreq.array.tobytes()
            self.req_sig_cache = sig
        return sig

    def clone(self) -> "TaskInfo":
        t = self.clone_shared()
        t.resreq = self.resreq.clone()
        t.init_resreq = self.init_resreq.clone()
        return t

    def clone_shared(self) -> "TaskInfo":
        """Detached, status-frozen copy that SHARES the (immutable-after-
        creation) resreq/init_resreq vectors — node-side storage uses this so
        later status changes don't leak into node accounting."""
        t = TaskInfo.__new__(TaskInfo)
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        t.resreq = self.resreq
        t.init_resreq = self.init_resreq
        t.priority = self.priority
        t.pod = self.pod
        t.req_sig_cache = self.req_sig_cache
        t.resreq_empty_cache = self.resreq_empty_cache
        t._blk = None
        t._row = 0
        blk = self._blk
        if blk is None:
            t._status = self._status
            t._node_name = self._node_name
            t._volume_ready = self._volume_ready
        else:
            row = self._row
            t._status = _STATUS_OBJ[int(blk.status[row])]
            t._node_name = blk.node_name[row]
            t._volume_ready = bool(blk.volume_ready[row])
        return t

    def _view_bound_to(self, blk: "_TaskRows", row: int) -> "TaskInfo":
        """A copy of this task's immutable identity bound to (blk, row)."""
        t = TaskInfo.__new__(TaskInfo)
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        t.resreq = self.resreq
        t.init_resreq = self.init_resreq
        t.priority = self.priority
        t.pod = self.pod
        t.req_sig_cache = self.req_sig_cache
        t.resreq_empty_cache = self.resreq_empty_cache
        t._blk = blk
        t._row = row
        t._status = TaskStatus.PENDING  # unused while bound
        t._node_name = ""
        t._volume_ready = False
        return t

    def __repr__(self) -> str:
        return (
            f"Task({self.namespace}/{self.name} uid={self.uid} job={self.job} "
            f"status={self.status.name} node={self.node_name!r})"
        )


class _TaskRows:
    """Columnar task state of one JobInfo.

    Ownership discipline (what makes zero-copy snapshots safe):

    * ``status`` / ``node_name`` / ``volume_ready`` are PRIVATE to this block —
      ``clone_state`` copies the first ``n`` rows.
    * ``cores`` (row -> the owning cache's TaskInfo, the immutable identity
      source) and ``uids`` are SHARED, append-only lists.  Deletion only
      removes the uid from ``row_of`` and zeroes the private status cell; the
      shared entries stay so clones holding older row spaces keep reading
      valid data.  Compaction REBINDS the owner's slots to fresh lists/arrays
      (never mutates shared ones in place) and remaps any live views.
    * the immutable per-row columns (``priority`` / ``creation`` /
      ``resreq_empty`` / ``has_scalars`` arrays and the request MATRICES) are
      shared and appended with reallocation-on-growth, so clones' refs stay
      valid for their rows.
    * byte signatures build lazily (``gen`` vs ``sig_gen``) and are shared by
      clones taken while valid.
    """

    __slots__ = (
        "n",
        "status",
        "node_name",
        "volume_ready",
        "cores",
        "uids",
        "row_of",
        "priority",
        "creation",
        "resreq_empty",
        "has_scalars",
        "constrained",
        "dyn_pred",
        "req_aff",
        "pref_aff",
        "req_matrix",
        "init_req_matrix",
        "sigs",
        "sig_codes",
        "uid_rank",
        "gen",
        "sig_gen",
        "status_gen",
        "dead",
        "r_dim",
    )

    def __init__(self, r_dim: int) -> None:
        self.n = 0
        cap = 8
        self.status = np.zeros(cap, dtype=np.int16)
        self.node_name = np.empty(cap, dtype=object)
        self.volume_ready = np.zeros(cap, dtype=bool)
        # Object ndarrays (not lists) so engine decode/grouping can gather
        # thousands of cores/uids with one fancy index instead of list comps.
        self.cores = np.empty(cap, dtype=object)
        self.uids = np.empty(cap, dtype=object)
        self.row_of: Dict[str, int] = {}
        self.priority = np.zeros(cap, dtype=np.int64)
        self.creation = np.zeros(cap, dtype=np.float64)
        self.resreq_empty = np.zeros(cap, dtype=bool)
        self.has_scalars = np.zeros(cap, dtype=bool)
        # Pod carries a node selector or tolerations: the tensor builders'
        # per-pod label/toleration extraction only walks constrained rows —
        # the typical 100k-task cycle has none and skips the loop entirely.
        self.constrained = np.zeros(cap, dtype=bool)
        # Pod-spec flags consumed columnar by the plugins each session, so
        # publication/scoring sweeps never materialize task views:
        #   dyn_pred — scan-dynamic predicates (host ports / pod affinity)
        #   req_aff  — required node affinity (device-mask row correction)
        #   pref_aff — preferred node affinity (static scorer contribution)
        self.dyn_pred = np.zeros(cap, dtype=bool)
        self.req_aff = np.zeros(cap, dtype=bool)
        self.pref_aff = np.zeros(cap, dtype=bool)
        # Request matrices are maintained INCREMENTALLY at append time (the
        # cost rides event ingestion, not the scheduling cycle); they only
        # rebuild wholesale at compaction.  Signatures build lazily per cycle.
        self.req_matrix = np.zeros((cap, r_dim), dtype=np.float64)
        self.init_req_matrix = np.zeros((cap, r_dim), dtype=np.float64)
        self.sigs: Optional[List[bytes]] = None
        # Numeric sort keys derived with the signatures (same validity): the
        # per-cycle task-order sort is a 4-key np.lexsort instead of a Python
        # tuple sort over 100k lambda calls.
        self.sig_codes: Optional[np.ndarray] = None  # i64, order-isomorphic to sigs
        self.uid_rank: Optional[np.ndarray] = None   # i64, order-isomorphic to uids
        self.gen = 0
        self.sig_gen = -1
        # Bumped on EVERY status write (vector or scalar): status-membership
        # caches (e.g. the unschedulable-condition short-circuit) key on it —
        # ``gen`` only tracks the task SET (append/kill).
        self.status_gen = 0
        self.dead = 0
        self.r_dim = r_dim

    # -- growth ---------------------------------------------------------------

    def _grow(self) -> None:
        cap = max(16, 2 * self.status.shape[0])
        for slot in ("status", "node_name", "volume_ready", "priority", "creation",
                     "resreq_empty", "has_scalars", "constrained", "dyn_pred",
                     "req_aff", "pref_aff", "cores", "uids"):
            old = getattr(self, slot)
            new = np.zeros(cap, dtype=old.dtype) if old.dtype != object else np.empty(cap, dtype=object)
            new[: old.shape[0]] = old
            setattr(self, slot, new)
        for slot in ("req_matrix", "init_req_matrix"):
            old = getattr(self, slot)
            new = np.zeros((cap, old.shape[1]), dtype=np.float64)
            new[: old.shape[0]] = old
            setattr(self, slot, new)

    def _widen(self, r: int) -> None:
        """Grow the request-matrix width (vocab registered new scalars)."""
        for slot in ("req_matrix", "init_req_matrix"):
            old = getattr(self, slot)
            new = np.zeros((old.shape[0], r), dtype=np.float64)
            new[:, : old.shape[1]] = old
            setattr(self, slot, new)
        self.r_dim = r
        self.sigs = None
        self.sig_gen = -1

    def append(self, core: TaskInfo, status: TaskStatus, node_name: str,
               volume_ready: bool) -> int:
        if self.n == self.status.shape[0]:
            self._grow()
        row = self.n
        self.n = row + 1
        self.status[row] = int(status)
        self.node_name[row] = node_name
        self.volume_ready[row] = volume_ready
        self.cores[row] = core
        self.uids[row] = core.uid
        self.row_of[core.uid] = row
        self.priority[row] = core.priority
        self.creation[row] = core.pod.creation_timestamp
        self.resreq_empty[row] = bool(core.resreq_empty)
        self.has_scalars[row] = core.resreq.has_scalars
        pod = core.pod
        self.constrained[row] = bool(
            pod is not None and (pod.node_selector or pod.tolerations)
        )
        aff = pod.affinity if pod is not None else None
        self.dyn_pred[row] = bool(
            pod is not None
            and (pod.host_ports or (aff and (aff.pod_affinity or aff.pod_anti_affinity)))
        )
        self.req_aff[row] = bool(aff and aff.node_required)
        self.pref_aff[row] = bool(aff and aff.node_preferred)
        arr = core.resreq.array
        if arr.shape[0] > self.r_dim:
            self._widen(arr.shape[0])
        self.req_matrix[row, : arr.shape[0]] = arr
        arr = core.init_resreq.array
        if arr.shape[0] > self.r_dim:
            self._widen(arr.shape[0])
        self.init_req_matrix[row, : arr.shape[0]] = arr
        self.gen += 1
        return row

    def kill(self, uid: str) -> int:
        """Tombstone a row (shared entries untouched — see class docstring)."""
        row = self.row_of.pop(uid)
        self.status[row] = 0
        self.dead += 1
        self.gen += 1
        return row

    # -- cloning (the snapshot path) ------------------------------------------

    def clone_state(self) -> "_TaskRows":
        blk = _TaskRows.__new__(_TaskRows)
        n = self.n
        blk.n = n
        blk.status = self.status[:n].copy()
        blk.node_name = self.node_name[:n].copy()
        blk.volume_ready = self.volume_ready[:n].copy()
        blk.cores = self.cores
        blk.uids = self.uids
        blk.row_of = dict(self.row_of)
        blk.priority = self.priority
        blk.creation = self.creation
        blk.resreq_empty = self.resreq_empty
        blk.has_scalars = self.has_scalars
        blk.constrained = self.constrained
        blk.dyn_pred = self.dyn_pred
        blk.req_aff = self.req_aff
        blk.pref_aff = self.pref_aff
        blk.req_matrix = self.req_matrix
        blk.init_req_matrix = self.init_req_matrix
        blk.sigs = self.sigs
        blk.sig_codes = self.sig_codes
        blk.uid_rank = self.uid_rank
        blk.gen = self.gen
        blk.sig_gen = self.sig_gen
        blk.status_gen = self.status_gen
        blk.dead = self.dead
        blk.r_dim = self.r_dim
        return blk

    # -- request signatures ----------------------------------------------------

    def sigs_valid(self) -> bool:
        return self.sig_gen == self.gen and self.sigs is not None

    def build_sigs(self) -> None:
        """Byte signatures sliced from the (incrementally maintained) matrix
        buffers: identical bytes to ``resreq.array.tobytes() +
        init_resreq.array.tobytes()`` at matrix width — the uniform width
        makes the sort tie-break consistent across tasks created at
        different vocabulary sizes."""
        n = self.n
        item = self.req_matrix.shape[1] * 8
        req_buf = self.req_matrix[:n].tobytes()
        init_buf = self.init_req_matrix[:n].tobytes()
        self.sigs = [
            req_buf[i * item : (i + 1) * item] + init_buf[i * item : (i + 1) * item]
            for i in range(n)
        ]
        # Numeric companions (same validity window): sig_codes ranks rows by
        # the SAME bytes the sigs compare as (memcmp over the concatenated
        # row == bytes.__lt__), uid_rank ranks uid strings — so a lexsort
        # over (codes, ranks) orders exactly like the tuple sort over
        # (sigs, uids), but in C per cycle instead of Python per task.
        if n:
            self.sig_codes, _ = unique_row_codes(
                np.concatenate([self.req_matrix[:n], self.init_req_matrix[:n]], axis=1)
            )
            order = np.argsort(self.uids[:n], kind="stable")
            rank = np.empty(n, dtype=np.int64)
            rank[order] = np.arange(n, dtype=np.int64)
            self.uid_rank = rank
        else:
            self.sig_codes = np.zeros(0, dtype=np.int64)
            self.uid_rank = np.zeros(0, dtype=np.int64)
        self.sig_gen = self.gen

    def _compact(self, views: Optional[Dict[str, TaskInfo]]) -> None:
        """Rebuild the row space dropping tombstones.  Owner-only: fresh lists
        and arrays are REBOUND into the slots (shared old ones stay valid for
        clones), and any live views of this block are remapped in place."""
        live = sorted(self.row_of.items(), key=lambda kv: kv[1])
        n = len(live)
        cap = max(8, n)
        status = np.zeros(cap, dtype=np.int16)
        node_name = np.empty(cap, dtype=object)
        volume_ready = np.zeros(cap, dtype=bool)
        priority = np.zeros(cap, dtype=np.int64)
        creation = np.zeros(cap, dtype=np.float64)
        resreq_empty = np.zeros(cap, dtype=bool)
        has_scalars = np.zeros(cap, dtype=bool)
        constrained = np.zeros(cap, dtype=bool)
        dyn_pred = np.zeros(cap, dtype=bool)
        req_aff = np.zeros(cap, dtype=bool)
        pref_aff = np.zeros(cap, dtype=bool)
        req = np.zeros((cap, self.r_dim), dtype=np.float64)
        init = np.zeros((cap, self.r_dim), dtype=np.float64)
        cores = np.empty(cap, dtype=object)
        uids = np.empty(cap, dtype=object)
        row_of: Dict[str, int] = {}
        for new_row, (uid, old_row) in enumerate(live):
            status[new_row] = self.status[old_row]
            node_name[new_row] = self.node_name[old_row]
            volume_ready[new_row] = self.volume_ready[old_row]
            priority[new_row] = self.priority[old_row]
            creation[new_row] = self.creation[old_row]
            resreq_empty[new_row] = self.resreq_empty[old_row]
            has_scalars[new_row] = self.has_scalars[old_row]
            constrained[new_row] = self.constrained[old_row]
            dyn_pred[new_row] = self.dyn_pred[old_row]
            req_aff[new_row] = self.req_aff[old_row]
            pref_aff[new_row] = self.pref_aff[old_row]
            req[new_row] = self.req_matrix[old_row]
            init[new_row] = self.init_req_matrix[old_row]
            core = self.cores[old_row]
            cores[new_row] = core
            uids[new_row] = uid
            row_of[uid] = new_row
            if core is not None and core._blk is self:
                core._row = new_row
        if views:
            for uid, view in views.items():
                if view._blk is self:
                    view._row = row_of[uid]
        self.n = n
        self.status = status
        self.node_name = node_name
        self.volume_ready = volume_ready
        self.priority = priority
        self.creation = creation
        self.resreq_empty = resreq_empty
        self.has_scalars = has_scalars
        self.constrained = constrained
        self.dyn_pred = dyn_pred
        self.req_aff = req_aff
        self.pref_aff = pref_aff
        self.req_matrix = req
        self.init_req_matrix = init
        self.cores = cores
        self.uids = uids
        self.row_of = row_of
        self.dead = 0
        self.sigs = None
        self.sig_codes = None
        self.uid_rank = None
        self.sig_gen = -1
        self.gen += 1


def unique_row_codes(matrix: np.ndarray):
    """``(codes, unique_rows)`` for a 2-D array: rows ranked by memcmp over
    their raw bytes (the void-view trick — identical ordering to comparing
    the rows' ``tobytes()``).  One definition shared by the task-store sort
    keys and the mega-kernel's request-signature table, so a subtlety fix
    (e.g. -0.0 bytes) lands in both."""
    both = np.ascontiguousarray(matrix)
    voids = both.view(np.dtype((np.void, both.shape[1] * both.itemsize))).ravel()
    uniq, inverse = np.unique(voids, return_inverse=True)
    uniq_rows = np.ascontiguousarray(uniq).view(both.dtype).reshape(
        uniq.shape[0], both.shape[1]
    )
    return inverse.astype(np.int64), uniq_rows


class JobInfo:
    """A gang job: all tasks of one PodGroup plus scheduling aggregates."""

    def __init__(self, uid: str, vocab: ResourceVocabulary) -> None:
        self.uid: str = uid
        self.vocab = vocab
        self.name: str = ""
        self.namespace: str = ""
        self.queue: str = ""
        self.priority: int = 0
        self.min_available: int = 0
        self.pod_group: Optional[PodGroup] = None

        self._store = _TaskRows(vocab.size)
        self._views: Optional[Dict[str, TaskInfo]] = None
        self._index: Optional[Dict[TaskStatus, Dict[str, TaskInfo]]] = None
        self._counts: Dict[int, int] = {}

        self.allocated: ResourceVec = ResourceVec.empty(vocab)
        self.total_request: ResourceVec = ResourceVec.empty(vocab)

        # Tasks mounting PersistentVolumeClaims.  Zero for nearly every job;
        # the cache's columnar volume hooks skip their per-row Python loop
        # entirely when it is 0, so claim-free jobs never pay for a real
        # VolumeBinder being configured.
        self.volume_claim_tasks: int = 0
        # Tasks whose pod carries ANY pod-affinity term (hard or preferred):
        # lets nodeorder skip registering the InterPodAffinity batch priority
        # (and thus keep the fused engine) when no pod could contribute.
        self.pod_affinity_tasks: int = 0

        self.creation_timestamp: float = 0.0

        # Why scheduling failed, for status conditions (job_info.go:150-157).
        self.nodes_fit_errors: Dict[str, FitErrors] = {}  # task uid -> FitErrors
        self.nodes_fit_delta: Dict[str, ResourceVec] = {}  # node -> shortfall
        self.job_fit_errors: str = ""

    # -- PodGroup binding ---------------------------------------------------

    def set_pod_group(self, pg: PodGroup) -> None:
        self.name = pg.name
        self.namespace = pg.namespace
        self.min_available = pg.min_member
        self.queue = pg.queue
        self.creation_timestamp = pg.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self.pod_group = None

    # -- columnar access ------------------------------------------------------

    @property
    def store(self) -> _TaskRows:
        """The columnar block (row-aligned with ``request_matrices``)."""
        return self._store

    @property
    def task_count(self) -> int:
        return len(self._store.row_of)

    def status_count(self, status: TaskStatus) -> int:
        return self._counts.get(int(status), 0)

    def _pad_row(self, row: np.ndarray) -> np.ndarray:
        """Pad a matrix-derived [R_matrix] row to the CURRENT vocab width —
        the matrices' width lags when scalars registered after this job's
        last task append."""
        r = self.vocab.size
        if row.shape[0] >= r:
            return row
        padded = np.zeros(r, dtype=np.float64)
        padded[: row.shape[0]] = row
        return padded

    def request_matrices(self):
        """(resreq, init_resreq, uid -> row): full-capacity [cap >= n, R_matrix]
        request matrices aligned with this job's row space, plus the live row
        map.  Gather by LIVE rows only — tombstoned rows keep stale values
        until compaction, and rows past ``store.n`` are uninitialized capacity.
        ``R_matrix`` can lag the current vocab width (see ``_pad_row``).
        Maintained incrementally at task add time — this is a plain accessor,
        never a build."""
        st = self._store
        return st.req_matrix, st.init_req_matrix, st.row_of

    def rows_with_status(self, status: TaskStatus) -> np.ndarray:
        st = self._store
        return np.nonzero(st.status[: st.n] == int(status))[0]

    def pending_rows(self) -> np.ndarray:
        """Live PENDING, non-best-effort rows (the allocate-eligible set)."""
        st = self._store
        mask = st.status[: st.n] == int(TaskStatus.PENDING)
        mask &= ~st.resreq_empty[: st.n]
        return np.nonzero(mask)[0]

    def pending_eligible_count(self) -> int:
        return int(self.pending_rows().shape[0])

    def _rows_builtin_sorted(self, rows: np.ndarray, use_priority: bool) -> np.ndarray:
        """Rows in builtin task order, straight from the columns: the tuple
        key ``(-priority, req_sig, creation, uid)`` (or without the priority
        term) — exactly ``utils.scheduler_helper.task_sort_key``'s fast path.
        ONE definition: allocate and preempt/reclaim must sort identically.

        Numeric 4-key lexsort (primary key LAST): total order — the unique
        uid rank breaks every tie — so the result is bit-identical to the
        old per-task Python tuple sort, amortized to a C sort per cycle."""
        if rows.shape[0] <= 1:
            return rows
        st = self._store
        if not st.sigs_valid() or st.sig_codes is None:
            st.build_sigs()
        keys = [st.uid_rank[rows], st.creation[rows], st.sig_codes[rows]]
        if use_priority:
            keys.append(-st.priority[rows])
        return rows[np.lexsort(tuple(keys))]

    def pending_rows_sorted(self, use_priority: bool) -> np.ndarray:
        """Allocate-eligible pending rows (best-effort excluded) in builtin
        task order, no task objects."""
        return self._rows_builtin_sorted(self.pending_rows(), use_priority)

    def view_for_row(self, row: int) -> TaskInfo:
        """The task view for a row (materializes just this one if needed)."""
        st = self._store
        uid = st.uids[row]
        if self._views is not None:
            view = self._views.get(uid)
            if view is not None:
                return view
        core = st.cores[row]
        if core._blk is st:
            view = core
        else:
            view = core._view_bound_to(st, row)
        if self._views is not None:
            self._views[uid] = view
        return view

    # -- lazy object materialization ------------------------------------------

    def _materialize(self) -> Dict[str, TaskInfo]:
        views = self._views
        if views is None:
            st = self._store
            cores = st.cores
            views = {}
            for uid, row in st.row_of.items():
                core = cores[row]
                if core._blk is st:
                    views[uid] = core
                else:
                    views[uid] = core._view_bound_to(st, row)
            self._views = views
        return views

    @property
    def tasks(self) -> Dict[str, TaskInfo]:
        return self._materialize()

    @property
    def task_status_index(self) -> Dict[TaskStatus, Dict[str, TaskInfo]]:
        index = self._index
        if index is None:
            views = self._materialize()
            st = self._store
            status_col = st.status
            index = {}
            for uid, view in views.items():
                status = _STATUS_OBJ[int(status_col[view._row])] if view._blk is st else view.status
                bucket = index.get(status)
                if bucket is None:
                    bucket = index[status] = {}
                bucket[uid] = view
            self._index = index
        return index

    # -- task CRUD (status-indexed, job_info.go:238-292) --------------------

    def _count_add(self, status_val: int, delta: int) -> None:
        c = self._counts.get(status_val, 0) + delta
        if c:
            self._counts[status_val] = c
        else:
            self._counts.pop(status_val, None)

    def add_task_info(self, ti: TaskInfo) -> None:
        if ti.uid in self._store.row_of:
            raise KeyError(f"task {ti.uid} already in job {self.uid}")
        status = ti.status
        node_name = ti.node_name
        volume_ready = ti.volume_ready
        ti._detach()
        row = self._store.append(ti, status, node_name, volume_ready)
        ti._blk = self._store
        ti._row = row
        self._count_add(int(status), 1)
        if allocated_status(status):
            self.allocated.add(ti.resreq)
        self.total_request.add(ti.resreq)
        if ti.pod is not None and ti.pod.volume_claims:
            self.volume_claim_tasks += 1
        if ti.pod is not None and _has_pod_affinity(ti.pod):
            self.pod_affinity_tasks += 1
        if self._views is not None:
            self._views[ti.uid] = ti
        if self._index is not None:
            self._index.setdefault(status, {})[ti.uid] = ti

    def delete_task_info(self, ti: TaskInfo) -> None:
        st = self._store
        row = st.row_of.get(ti.uid)
        if row is None:
            raise KeyError(f"task {ti.namespace}/{ti.name} not in job {self.uid}")
        status = _STATUS_OBJ[int(st.status[row])]
        core = st.cores[row]
        if allocated_status(status):
            self.allocated.sub(core.resreq)
        self.total_request.sub(core.resreq)
        if core.pod is not None and core.pod.volume_claims:
            self.volume_claim_tasks -= 1
        if core.pod is not None and _has_pod_affinity(core.pod):
            self.pod_affinity_tasks -= 1
        # Detach live views/cores of this row so held refs keep final values.
        if core._blk is st:
            core._detach()
        if self._views is not None:
            view = self._views.pop(ti.uid, None)
            if view is not None and view._blk is st:
                view._detach()
        if ti._blk is st:
            ti._detach()
        if self._index is not None:
            bucket = self._index.get(status)
            if bucket is not None:
                bucket.pop(ti.uid, None)
                if not bucket:
                    del self._index[status]
        st.kill(ti.uid)
        self._count_add(int(status), -1)
        # Compact HERE (not at matrix build): no caller holds raw row indices
        # across a delete — engines work on session clones (own stores) and
        # cross-store row reuse is generation-guarded — whereas matrix builds
        # happen mid-cycle with live row sets in flight.  This also bounds
        # storage for churning jobs that never rebuild matrices.
        if st.dead > max(64, len(st.row_of)):
            st._compact(self._views)

    def update_task_status(self, ti: TaskInfo, status: TaskStatus) -> None:
        """Move a task between status buckets, maintaining the allocated aggregate."""
        st = self._store
        row = st.row_of.get(ti.uid)
        if row is None:
            raise KeyError(f"task {ti.uid} not in job {self.uid}")
        old_val = int(st.status[row])
        new_val = int(status)
        core = st.cores[row]
        resreq = core.resreq if core is not None else ti.resreq
        if old_val & _ALLOC_BITS:
            self.allocated.sub(resreq)
        st.status[row] = new_val
        st.status_gen += 1
        if ti._blk is not st:
            ti.status = status  # caller's detached/foreign object tracks too
        if new_val & _ALLOC_BITS:
            self.allocated.add(resreq)
        self._count_add(old_val, -1)
        self._count_add(new_val, 1)
        if self._index is not None:
            old_status = _STATUS_OBJ[old_val]
            bucket = self._index.get(old_status)
            view = None
            if bucket is not None:
                view = bucket.pop(ti.uid, None)
                if not bucket:
                    del self._index[old_status]
            if view is None:
                view = self.view_for_row(row)
            self._index.setdefault(status, {})[ti.uid] = view

    def bulk_update_status_rows(
        self,
        rows: np.ndarray,
        status: TaskStatus,
        net_add: Optional[np.ndarray] = None,
        assume_unique: bool = False,
        assume_from: Optional[TaskStatus] = None,
    ) -> None:
        """Vectorized ``update_task_status`` over row indices: one column
        write, O(statuses) count updates, one dense aggregate delta.

        ``net_add`` ([R] row, optional): precomputed sum of the batch's resreq
        rows (CommitPlan) — valid only when every row moves from a
        non-allocated to an allocated status.  ``assume_unique`` skips the
        duplicate sort for callers whose rows are unique by construction (the
        device engines place each row at most once per action).
        ``assume_from``: every row currently holds this status (engine rows
        are PENDING by construction; a ready job's deferred dispatch moves
        ALLOCATED rows) — skips the old-status gather and its histogram.
        Verified under PANIC_ON_ERROR (the test regime).
        """
        if len(rows) == 0:
            return
        st = self._store
        if assume_from is not None and len(rows) > 1:
            rows = np.asarray(rows)
            if not assume_unique:
                rows = np.unique(rows)
            from_val = int(assume_from)
            new_val = int(status)
            if _panic_on_error() and not bool(
                np.all(st.status[rows] == np.int16(from_val))
            ):
                raise AssertionError(
                    f"assume_from={assume_from} violated in bulk status update"
                )
            if from_val == new_val:
                return
            if (
                net_add is not None
                and (from_val & _ALLOC_BITS)
                and not (new_val & _ALLOC_BITS)
            ):
                # Same check _apply_batched_status_bookkeeping performs, but
                # BEFORE the status scatter: a caller catching the ValueError
                # must find state untouched, not a written column with stale
                # counts/allocated/index.
                raise ValueError(
                    "net_add given but batch contains an allocated->non-allocated transition"
                )
            st.status[rows] = new_val
            self._apply_batched_status_bookkeeping(
                rows.shape[0], from_val, new_val, net_add, rows
            )
            return
        if len(rows) == 1:
            # Scalar fast path: thousands of single-task (shadow-PodGroup)
            # jobs each pay this per cycle — the vector machinery below costs
            # ~40us of numpy overhead per call against ~3us here.
            row = int(rows[0])
            old_val = int(st.status[row])
            new_val = int(status)
            if old_val == new_val:
                return
            core = st.cores[row]
            was_alloc = bool(old_val & _ALLOC_BITS)
            now_alloc = bool(new_val & _ALLOC_BITS)
            if was_alloc and not now_alloc:
                if net_add is not None:
                    raise ValueError(
                        "net_add given but batch contains an allocated->non-allocated transition"
                    )
                self.allocated.sub(core.resreq)
            elif now_alloc and not was_alloc:
                self.allocated.add(core.resreq)
            st.status[row] = new_val
            st.status_gen += 1
            self._count_add(old_val, -1)
            self._count_add(new_val, 1)
            self._index = None  # rebuilt lazily; views stay valid
            return
        rows = np.asarray(rows)
        if rows.shape[0] > 1 and not assume_unique:
            # A repeat in one batch is a no-op the second time (sequential
            # update_task_status would see status already == target).
            rows = np.unique(rows)
        old = st.status[rows]
        new_val = int(status)
        now_alloc = bool(new_val & _ALLOC_BITS)
        was_alloc = (old.astype(np.int64) & _ALLOC_BITS) != 0
        sub_rows = rows[was_alloc] if not now_alloc else rows[:0]
        add_rows = rows[~was_alloc] if now_alloc else rows[:0]
        if sub_rows.shape[0] and net_add is not None:
            raise ValueError(
                "net_add given but batch contains an allocated->non-allocated transition"
            )
        if sub_rows.shape[0] or (add_rows.shape[0] and net_add is None):
            req, _, _ = self.request_matrices()
        if sub_rows.shape[0]:
            self.allocated.sub_array(self._pad_row(req[sub_rows].sum(axis=0)))
        if net_add is not None and add_rows.shape[0]:
            self.allocated.add_array(self._pad_row(net_add))
        elif add_rows.shape[0]:
            self.allocated.add_array(
                self._pad_row(req[add_rows].sum(axis=0)),
                bool(st.has_scalars[add_rows].any()),
            )
        # Counts: one bincount over the old values.
        vals, cnts = np.unique(old, return_counts=True)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            self._count_add(int(v), -int(c))
        self._count_add(new_val, int(rows.shape[0]))
        st.status[rows] = new_val
        st.status_gen += 1
        self._index = None  # rebuilt lazily; views stay valid

    def _apply_batched_status_bookkeeping(
        self, n: int, from_val: int, new_val: int, net_add, rows
    ) -> None:
        """The O(1)-per-job half of a batched assume_from status move (the
        native scatter wrote the status column): allocated aggregate, counts,
        generation, index invalidation — exactly the vector path's updates."""
        st = self._store
        was_alloc = bool(from_val & _ALLOC_BITS)
        now_alloc = bool(new_val & _ALLOC_BITS)
        if was_alloc and not now_alloc:
            if net_add is not None:
                raise ValueError(
                    "net_add given but batch contains an allocated->non-allocated transition"
                )
            req, _, _ = self.request_matrices()
            self.allocated.sub_array(self._pad_row(req[rows].sum(axis=0)))
        elif now_alloc and not was_alloc:
            if net_add is not None:
                self.allocated.add_array(self._pad_row(net_add))
            else:
                req, _, _ = self.request_matrices()
                self.allocated.add_array(
                    self._pad_row(req[rows].sum(axis=0)),
                    bool(st.has_scalars[rows].any()),
                )
        st.status_gen += 1
        self._count_add(from_val, -n)
        self._count_add(new_val, n)
        self._index = None  # rebuilt lazily; views stay valid

    def bulk_update_status(self, tasks: list, status: TaskStatus, net_add=None) -> None:
        """Batch ``update_task_status`` over task objects (object-path API).
        Equivalent final state to calling update_task_status per task; repeats
        in one batch are no-ops the second time."""
        if not tasks:
            return
        st = self._store
        row_of = st.row_of
        rows = []
        foreign = []
        for ti in tasks:
            row = row_of.get(ti.uid)
            if row is None:
                raise KeyError(f"task {ti.uid} not in job {self.uid}")
            rows.append(row)
            if ti._blk is not st:
                foreign.append(ti)
        self.bulk_update_status_rows(np.asarray(rows, dtype=np.int64), status, net_add)
        for ti in foreign:
            ti.status = status

    def set_node_names_rows(self, rows: np.ndarray, names) -> None:
        """Vectorized ``task.node_name = ...`` over rows.  ``names`` is a str
        (broadcast) or a sequence aligned with ``rows``."""
        if len(rows) == 0:
            return
        col = self._store.node_name
        if isinstance(names, str):
            col[rows] = names
        else:
            col[np.asarray(rows)] = np.asarray(names, dtype=object)

    # -- gang arithmetic (job_info.go:367-418) ------------------------------

    def ready_task_num(self) -> int:
        c = self._counts
        return (
            c.get(int(TaskStatus.BOUND), 0)
            + c.get(int(TaskStatus.BINDING), 0)
            + c.get(int(TaskStatus.RUNNING), 0)
            + c.get(int(TaskStatus.ALLOCATED), 0)
            + c.get(int(TaskStatus.SUCCEEDED), 0)
        )

    def waiting_task_num(self) -> int:
        return self._counts.get(int(TaskStatus.PIPELINED), 0)

    def valid_task_num(self) -> int:
        return (
            self.ready_task_num()
            + self._counts.get(int(TaskStatus.PIPELINED), 0)
            + self._counts.get(int(TaskStatus.PENDING), 0)
        )

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    def fit_error(self) -> str:
        """Histogram of task statuses for unschedulable messages (job_info.go:344-364)."""
        reasons = {str(_STATUS_OBJ[v]): c for v, c in self._counts.items() if c}
        reasons["minAvailable"] = self.min_available
        sorted_strs = sorted(f"{v} {k}" for k, v in reasons.items())
        return "job is not ready, {}.".format(", ".join(sorted_strs))

    # -- clone (job_info.go:295-329) ----------------------------------------

    def clone(self) -> "JobInfo":
        """Status-isolated clone (job_info.go:295-329): copies the three mutable
        columns and shares everything immutable — O(arrays), no per-task work.
        Materializing the clone's ``tasks`` yields exactly the dict the
        reference's per-task deep copy would."""
        job = JobInfo.__new__(JobInfo)
        job.uid = self.uid
        job.vocab = self.vocab
        job.name = self.name
        job.namespace = self.namespace
        job.queue = self.queue
        job.priority = self.priority
        job.min_available = self.min_available
        job.pod_group = self.pod_group
        job.creation_timestamp = self.creation_timestamp
        job._store = self._store.clone_state()
        job._views = None
        job._index = None
        job._counts = dict(self._counts)
        job.volume_claim_tasks = self.volume_claim_tasks
        job.pod_affinity_tasks = self.pod_affinity_tasks
        job.allocated = self.allocated.clone()
        job.total_request = self.total_request.clone()
        job.nodes_fit_errors = {}
        job.nodes_fit_delta = {}
        job.job_fit_errors = ""
        return job

    def __repr__(self) -> str:
        return (
            f"Job({self.namespace}/{self.name} uid={self.uid} queue={self.queue} "
            f"minAvailable={self.min_available} tasks={self.task_count})"
        )


def batch_update_status_rows(entries) -> None:
    """Many jobs' ``bulk_update_status_rows(assume_from=...)`` calls as ONE
    native scatter pass + O(1)-per-job bookkeeping (``native.
    batch_status_scatter``): the apply phase previously paid ~13us of numpy
    per-call overhead across ~2000 per-job calls.

    ``entries``: ``[(job, rows, status, net_add, assume_from)]`` with unique
    rows per entry (engine placement rows are unique by construction).
    State-equivalent to the per-job calls.  Under PANIC_ON_ERROR an
    assume_from violation raises AFTER the scatter wrote (the per-job numpy
    path raises before) — the divergence exists only in the already-fatal
    violation case, and the raise carries the violating job either way.
    """
    from scheduler_tpu_torch import native

    live = []
    for job, rows, status, net_add, assume_from in entries:
        if len(rows) == 0 or int(status) == int(assume_from):
            continue
        live.append(
            (job, np.asarray(rows), int(status), net_add, int(assume_from))
        )
    if not live:
        return
    offsets = np.zeros(len(live) + 1, dtype=np.int64)
    for i, (_, rows, _s, _n, _f) in enumerate(live):
        offsets[i + 1] = offsets[i] + rows.shape[0]
    rows_flat = (
        np.concatenate([rows for _, rows, _s, _n, _f in live])
        .astype(np.int64, copy=False)
    )
    bad = native.batch_status_scatter(
        [job.store.status for job, _r, _s, _n, _f in live],
        rows_flat,
        offsets,
        np.asarray([f for _j, _r, _s, _n, f in live], dtype=np.int16),
        np.asarray([s for _j, _r, s, _n, _f in live], dtype=np.int16),
        _panic_on_error(),
    )
    if bad >= 0:
        raise AssertionError(
            "assume_from violated in batched status update "
            f"(job {live[bad][0].uid})"
        )
    for job, rows, status, net_add, assume_from in live:
        job._apply_batched_status_bookkeeping(
            rows.shape[0], assume_from, status, net_add, rows
        )
