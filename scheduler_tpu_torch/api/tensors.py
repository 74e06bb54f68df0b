"""Snapshot tensors: the dense struct-of-arrays encoding of a scheduling Session.

This is the host↔device boundary of the framework.  The reference walks pointer
webs (JobInfo.TaskStatusIndex, NodeInfo.Tasks) with 16 goroutines
(``util/scheduler_helper.go:34-129``); here the same information is laid out as
resource matrices and index vectors so one kernel launch can sweep every
(task, node) pair:

* nodes  → ``NodeTensors``: [N, R] idle/releasing/used/allocatable matrices +
  pod-count rows + a [N, L] label-pair membership mask.
* tasks  → ``TaskTensors``: [T, R] request matrices, job index vector, priority /
  creation vectors, [T, L] selector requirement mask.
* jobs   → ``JobTensors``: min_available / queue index / priority vectors.

Label vocabulary: every distinct (key, value) label pair seen on nodes or in
selectors gets one column; "task selector ⊆ node labels" then compiles to a
boolean matmul.  Builders emit exact-size arrays; the device engine pads them
to power-of-two buckets (``bucket``) at transfer time, the same buckets as the
JAX package, so both stage kernel operands of identical shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.vocab import ResourceVocabulary


def bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity — used by the device engine to pad tensor
    shapes (the JAX package's buckets, so operands match it shape for shape)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class LabelVocab:
    """Append-only (key, value) label-pair vocabulary shared by one snapshot."""

    def __init__(self) -> None:
        self._index: Dict[Tuple[str, str], int] = {}

    def index(self, key: str, value: str) -> int:
        pair = (key, value)
        idx = self._index.get(pair)
        if idx is None:
            idx = len(self._index)
            self._index[pair] = idx
        return idx

    def lookup(self, key: str, value: str) -> Optional[int]:
        return self._index.get((key, value))

    @property
    def size(self) -> int:
        return len(self._index)


class TaintVocab:
    """Append-only (key, value, effect) taint vocabulary for one snapshot.

    Only scheduling-relevant effects (NoSchedule / NoExecute) get columns; a
    node's taint membership row and a task's toleration-coverage row over the
    same columns turn PodToleratesNodeTaints into a boolean matmul.
    """

    SCHEDULING_EFFECTS = ("NoSchedule", "NoExecute")

    def __init__(self) -> None:
        self._index: Dict[Tuple[str, str, str], int] = {}
        self.taints: List = []  # Taint object per column

    def index(self, taint) -> Optional[int]:
        if taint.effect not in self.SCHEDULING_EFFECTS:
            return None
        key = (taint.key, taint.value, taint.effect)
        idx = self._index.get(key)
        if idx is None:
            idx = len(self._index)
            self._index[key] = idx
            self.taints.append(taint)
        return idx

    @property
    def size(self) -> int:
        return len(self._index)


@dataclass
class NodeTensors:
    names: List[str]
    index: Dict[str, int]
    idle: np.ndarray          # f64 [N, R]
    releasing: np.ndarray     # f64 [N, R]
    used: np.ndarray          # f64 [N, R]
    allocatable: np.ndarray   # f64 [N, R]
    pods_limit: np.ndarray    # i32 [N]
    task_count: np.ndarray    # i32 [N]
    ready: np.ndarray         # bool [N]
    unschedulable: np.ndarray  # bool [N]
    labels: np.ndarray        # bool [N, L]
    taints: np.ndarray        # bool [N, K] taint membership

    @property
    def count(self) -> int:
        return len(self.names)


class TaskTensors:
    """Flat task columns (see builders below).

    ``uids``/``index`` are LAZY on the columnar path: only the per-pop host
    engine and tests resolve them, so the hot path never builds 100k Python
    strings/dict entries.  Pass them eagerly (object path) or as
    ``uid_fragments`` = [(uids_column, rows)] gathered on first access.
    """

    def __init__(
        self,
        resreq: np.ndarray,        # f64 [T, R]
        init_resreq: np.ndarray,   # f64 [T, R]
        job_idx: np.ndarray,       # i32 [T]  (into JobTensors)
        best_effort: np.ndarray,   # bool [T] (init_resreq below every epsilon)
        selector: np.ndarray,      # bool [T, L] required label pairs
        has_unknown_selector: np.ndarray,  # bool [T]: selector pair no node has
        tolerated: np.ndarray,     # bool [T, K] tolerated taint columns
        priority: Optional[np.ndarray] = None,   # i32 [T]
        creation: Optional[np.ndarray] = None,   # f64 [T]
        req_aff: Optional[np.ndarray] = None,
        pref_aff: Optional[np.ndarray] = None,
        cores: Optional[np.ndarray] = None,
        uids: Optional[List[str]] = None,
        index: Optional[Dict[str, int]] = None,
        uid_fragments: Optional[list] = None,
    ) -> None:
        self.resreq = resreq
        self.init_resreq = init_resreq
        self.job_idx = job_idx
        self._priority = priority
        self._creation = creation
        self.best_effort = best_effort
        self.selector = selector
        self.has_unknown_selector = has_unknown_selector
        self.tolerated = tolerated
        # Affinity flags + task cores: plugins walk ONLY the flagged rows (the
        # typical cycle has none) instead of building uid->task dicts.
        self.req_aff = req_aff if req_aff is not None else np.zeros(0, dtype=bool)
        self.pref_aff = pref_aff if pref_aff is not None else np.zeros(0, dtype=bool)
        self._cores = cores
        self._uids = uids
        self._index = index
        self._uid_fragments = uid_fragments

    @property
    def cores(self) -> np.ndarray:
        if self._cores is None:
            out = np.empty(self.count, dtype=object)
            base = 0
            for store, rows in self._store_fragments:
                n = len(rows)
                out[base : base + n] = store.cores[rows]
                base += n
            self._cores = out
        return self._cores

    @property
    def priority(self) -> np.ndarray:
        if self._priority is None:
            out = np.zeros(self.count, dtype=np.int32)
            base = 0
            for store, rows in self._store_fragments:
                n = len(rows)
                out[base : base + n] = store.priority[rows]
                base += n
            self._priority = out
        return self._priority

    @property
    def creation(self) -> np.ndarray:
        if self._creation is None:
            out = np.zeros(self.count)
            base = 0
            for store, rows in self._store_fragments:
                n = len(rows)
                out[base : base + n] = store.creation[rows]
                base += n
            self._creation = out
        return self._creation

    @property
    def _store_fragments(self):
        return self._uid_fragments or ()

    @property
    def uids(self) -> List[str]:
        if self._uids is None:
            out: List[str] = []
            for store, rows in self._store_fragments:
                out.extend(store.uids[rows].tolist())
            self._uids = out
        return self._uids

    @property
    def index(self) -> Dict[str, int]:
        if self._index is None:
            self._index = {uid: i for i, uid in enumerate(self.uids)}
        return self._index

    @property
    def count(self) -> int:
        return self.resreq.shape[0]


@dataclass
class JobTensors:
    uids: List[str]
    index: Dict[str, int]
    min_available: np.ndarray  # i32 [J]
    queue_idx: np.ndarray      # i32 [J]
    priority: np.ndarray       # i32 [J]
    creation: np.ndarray       # f64 [J]


@dataclass
class SnapshotTensors:
    vocab: ResourceVocabulary
    label_vocab: LabelVocab
    taint_vocab: TaintVocab
    min_thresholds: np.ndarray  # f64 [R]
    nodes: NodeTensors
    tasks: TaskTensors
    jobs: JobTensors
    queue_names: List[str] = field(default_factory=list)


class NodeStaticCache:
    """Static node-side tensor columns memoized across cycles.

    Names/labels/taints/allocatable/pods_limit/unschedulable (and the label
    and taint vocabularies built from them) are pure functions of the node
    SPECS, which change only through node add/update/delete events; the
    owner (SchedulerCache) bumps a generation counter on those, and the key
    carries it.  One entry — cycles share one cluster."""

    __slots__ = ("key", "value")

    def __init__(self) -> None:
        self.key = None
        self.value = None

    def get(self, key):
        return self.value if key == self.key else None

    def put(self, key, value) -> None:
        self.key, self.value = key, value


class _NodeStatic:
    __slots__ = (
        "names", "index", "allocatable", "pods_limit", "unschedulable",
        "labels", "taints", "label_vocab", "taint_vocab",
    )


def _build_node_static(
    nodes: Sequence[NodeInfo],
    vocab: ResourceVocabulary,
    label_vocab: LabelVocab,
    taint_vocab: TaintVocab,
) -> _NodeStatic:
    n = len(nodes)
    r = vocab.size
    # First pass registers every node label pair / taint so mask widths are final.
    for ni in nodes:
        if ni.node is not None:
            for k, v in ni.node.labels.items():
                label_vocab.index(k, v)
            # hostname is an implicit label for topology/affinity matching
            label_vocab.index("kubernetes.io/hostname", ni.name)
            for taint in ni.node.taints:
                taint_vocab.index(taint)

    st = _NodeStatic()
    st.label_vocab = label_vocab
    st.taint_vocab = taint_vocab
    st.allocatable = np.zeros((n, r))
    st.pods_limit = np.zeros(n, dtype=np.int32)
    st.unschedulable = np.zeros(n, dtype=bool)
    st.labels = np.zeros((n, label_vocab.size), dtype=bool)
    st.taints = np.zeros((n, taint_vocab.size), dtype=bool)
    st.names = []
    for i, ni in enumerate(nodes):
        st.names.append(ni.name)
        st.allocatable[i] = _fit(ni.allocatable.array, r)
        st.pods_limit[i] = ni.pods_limit
        if ni.node is not None:
            st.unschedulable[i] = ni.node.unschedulable
            for k, v in ni.node.labels.items():
                st.labels[i, label_vocab.index(k, v)] = True
            st.labels[i, label_vocab.index("kubernetes.io/hostname", ni.name)] = True
            for taint in ni.node.taints:
                col = taint_vocab.index(taint)
                if col is not None:
                    st.taints[i, col] = True
    st.index = {name: i for i, name in enumerate(st.names)}
    return st


def build_node_tensors(
    nodes: Sequence[NodeInfo],
    vocab: ResourceVocabulary,
    label_vocab: LabelVocab,
    taint_vocab: TaintVocab,
    static: Optional[_NodeStatic] = None,
) -> NodeTensors:
    """``static`` — a memoized ``_NodeStatic`` for this exact node set (same
    names in the same order); when given, its vocabs REPLACE the passed-in
    empty ones and only the dynamic columns rebuild."""
    n = len(nodes)
    r = vocab.size
    if static is None:
        static = _build_node_static(nodes, vocab, label_vocab, taint_vocab)

    idle = np.zeros((n, r))
    releasing = np.zeros((n, r))
    used = np.zeros((n, r))
    task_count = np.zeros(n, dtype=np.int32)
    ready = np.zeros(n, dtype=bool)
    for i, ni in enumerate(nodes):
        idle[i] = _fit(ni.idle.array, r)
        releasing[i] = _fit(ni.releasing.array, r)
        used[i] = _fit(ni.used.array, r)
        task_count[i] = ni.task_count  # eager counter: no view materialization
        ready[i] = ni.ready()

    return NodeTensors(
        names=static.names,
        index=static.index,
        idle=idle,
        releasing=releasing,
        used=used,
        allocatable=static.allocatable,
        pods_limit=static.pods_limit,
        task_count=task_count,
        ready=ready,
        unschedulable=static.unschedulable,
        labels=static.labels,
        taints=static.taints,
    )


def _fit(arr: np.ndarray, r: int) -> np.ndarray:
    if arr.shape[0] == r:
        return arr
    out = np.zeros(r)
    out[: arr.shape[0]] = arr
    return out


def build_node_tensors_from_ledger(
    node_map,
    vocab: ResourceVocabulary,
    label_vocab: LabelVocab,
    taint_vocab: TaintVocab,
    static: Optional[_NodeStatic] = None,
) -> NodeTensors:
    """``build_node_tensors`` straight off a session's ``LedgerNodeMap``: the
    dynamic columns are row GATHERS from the cloned ledger matrices (sorted-
    name order), touching zero node objects.  Only a static-cache miss (node
    generation changed) materializes views to rebuild label/taint columns."""
    led = node_map.ledger
    if led.r < vocab.size:
        led.widen(vocab.size)
    r = vocab.size
    order = led.sorted_rows()
    if static is None:
        names = led.sorted_names()
        static = _build_node_static(
            [node_map[name] for name in names], vocab, label_vocab, taint_vocab
        )
    return NodeTensors(
        names=static.names,
        index=static.index,
        idle=led.idle[order][:, :r],
        releasing=led.releasing[order][:, :r],
        used=led.used[order][:, :r],
        allocatable=static.allocatable,
        pods_limit=static.pods_limit,
        task_count=led.task_count[order].astype(np.int32),
        ready=led.ready[order],
        unschedulable=static.unschedulable,
        labels=static.labels,
        taints=static.taints,
    )


def build_task_tensors_columnar(
    per_job: Sequence,
    jobs: JobTensors,
    vocab: ResourceVocabulary,
    label_vocab: LabelVocab,
    taint_vocab: TaintVocab,
) -> TaskTensors:
    """Task tensors from ``(JobInfo, rows)`` pairs — request rows, priority
    and creation gather straight from the job stores (the matrices ARE
    copies of each task's vectors); only
    selector/toleration extraction touches pod objects, and no TaskInfo views
    are materialized at all."""
    t = sum(len(rows) for _, rows in per_job)
    r = vocab.size
    mins = vocab.min_thresholds()
    resreq = np.zeros((t, r))
    init_resreq = np.zeros((t, r))
    job_idx = np.full(t, -1, dtype=np.int32)
    selector = np.zeros((t, label_vocab.size), dtype=bool)
    has_unknown = np.zeros(t, dtype=bool)
    tolerated = np.zeros((t, taint_vocab.size), dtype=bool)
    req_aff = np.zeros(t, dtype=bool)
    pref_aff = np.zeros(t, dtype=bool)
    fragments: List = []  # (store, rows) — uids/cores/priority/creation gather lazily

    taints = taint_vocab.taints
    base = 0
    for job, rows in per_job:
        n = len(rows)
        if n == 0:
            continue
        st = job.store
        req_m, init_m, _ = job.request_matrices()
        width = min(req_m.shape[1], r)
        resreq[base : base + n, :width] = req_m[rows, :width]
        init_resreq[base : base + n, :width] = init_m[rows, :width]
        job_idx[base : base + n] = jobs.index.get(job.uid, -1)
        req_aff[base : base + n] = st.req_aff[rows]
        pref_aff[base : base + n] = st.pref_aff[rows]
        fragments.append((st, rows))
        # Only rows whose pod carries a selector or tolerations need the
        # per-pod extraction walk; an unconstrained pod contributes exactly
        # the zero rows these arrays are initialized to.
        cons = st.constrained[rows]
        if cons.any():
            sub = np.nonzero(cons)[0]
            cores_sel = st.cores[rows[sub]].tolist()
            for k, core in zip(sub.tolist(), cores_sel):
                pod = core.pod
                sel = pod.node_selector
                if sel:
                    for key, value in sel.items():
                        idx = label_vocab.lookup(key, value)
                        if idx is None:
                            has_unknown[base + k] = True
                        else:
                            selector[base + k, idx] = True
                if taints:
                    tols = pod.tolerations
                    for col, taint in enumerate(taints):
                        if any(tol.tolerates(taint) for tol in tols):
                            tolerated[base + k, col] = True
        base += n

    best_effort = np.all(init_resreq < mins[None, :], axis=1)
    return TaskTensors(
        uid_fragments=fragments,
        resreq=resreq,
        init_resreq=init_resreq,
        job_idx=job_idx,
        best_effort=best_effort,
        selector=selector,
        has_unknown_selector=has_unknown,
        tolerated=tolerated,
        req_aff=req_aff,
        pref_aff=pref_aff,
    )


def build_job_tensors(jobs: Sequence[JobInfo], queue_names: List[str]) -> JobTensors:
    j = len(jobs)
    queue_index = {name: i for i, name in enumerate(queue_names)}
    min_available = np.zeros(j, dtype=np.int32)
    queue_idx = np.full(j, -1, dtype=np.int32)
    priority = np.zeros(j, dtype=np.int32)
    creation = np.zeros(j)
    uids: List[str] = []
    for i, job in enumerate(jobs):
        uids.append(job.uid)
        min_available[i] = job.min_available
        queue_idx[i] = queue_index.get(job.queue, -1)
        priority[i] = job.priority
        creation[i] = job.creation_timestamp
    return JobTensors(
        uids=uids,
        index={uid: i for i, uid in enumerate(uids)},
        min_available=min_available,
        queue_idx=queue_idx,
        priority=priority,
        creation=creation,
    )


def build_snapshot_tensors_columnar(
    nodes: Iterable[NodeInfo],
    jobs: Iterable[JobInfo],
    per_job: Sequence,
    queue_names: List[str],
    vocab: ResourceVocabulary,
    node_cache: Optional[NodeStaticCache] = None,
    node_key=None,
) -> SnapshotTensors:
    """Node, job and task tensors of a session, with task rows given as
    ``(job, rows)`` pairs (job-store row indices).  ``node_cache`` +
    ``node_key`` (e.g. the owning cache's node generation) memoize the static
    node columns and vocabularies across cycles."""
    ledger_map = nodes if hasattr(nodes, "ledger") else None
    job_list = list(jobs)
    static = (
        node_cache.get(node_key)
        if node_cache is not None and node_key is not None
        else None
    )
    node_list = None
    if static is None:
        label_vocab = LabelVocab()
        taint_vocab = TaintVocab()
        if ledger_map is not None:
            # Static-cache miss (node generation moved): the ONE path that
            # materializes every node view this cycle.
            node_list = [ledger_map[n] for n in ledger_map.ledger.sorted_names()]
        else:
            node_list = sorted(nodes, key=lambda n: n.name)
        static = _build_node_static(node_list, vocab, label_vocab, taint_vocab)
        if node_cache is not None and node_key is not None:
            node_cache.put(node_key, static)
    else:
        label_vocab = static.label_vocab
        taint_vocab = static.taint_vocab
    if ledger_map is not None:
        node_tensors = build_node_tensors_from_ledger(
            ledger_map, vocab, label_vocab, taint_vocab, static=static
        )
    else:
        if node_list is None:
            node_list = sorted(nodes, key=lambda n: n.name)
        node_tensors = build_node_tensors(
            node_list, vocab, label_vocab, taint_vocab, static=static
        )
    job_tensors = build_job_tensors(job_list, queue_names)
    task_tensors = build_task_tensors_columnar(
        per_job, job_tensors, vocab, label_vocab, taint_vocab
    )
    return SnapshotTensors(
        vocab=vocab,
        label_vocab=label_vocab,
        taint_vocab=taint_vocab,
        min_thresholds=vocab.min_thresholds(),
        nodes=node_tensors,
        tasks=task_tensors,
        jobs=job_tensors,
        queue_names=list(queue_names),
    )
