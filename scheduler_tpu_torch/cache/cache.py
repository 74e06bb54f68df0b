"""SchedulerCache: mutable mirror of cluster state + side-effect executors.

Reference: ``pkg/scheduler/cache/cache.go`` and ``event_handlers.go``.  Events
arrive through the ``add_*/update_*/delete_*`` methods (the reference's informer
callbacks — here invoked directly by an adapter, the test harness, or the synthetic
workload driver); the scheduler only ever sees a deep-cloned ``snapshot()``.
Snapshot isolation is the consistency model: decisions are made on a frozen copy;
drift self-heals on the next cycle.

Bind/evict mutate local state synchronously, then fire the Binder/Evictor
asynchronously; failures roll the local mutation back (the standalone analogue of
the reference's errTasks resync queue, ``cache.go:559-581``).  A cache
wired to an API server (``connector.connect_cache``) re-fetches a failed
pod from its system of record first (``client()``, the syncTask seam).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from scheduler_tpu_torch.api.cluster_info import ClusterInfo
from scheduler_tpu_torch.api.job_info import JobInfo, TaskInfo, job_id_for_pod
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.queue_info import QueueInfo
from scheduler_tpu_torch.api.types import TaskStatus
from scheduler_tpu_torch.api.unschedule_info import ALL_NODE_UNAVAILABLE
from scheduler_tpu_torch.api.vocab import ResourceVocabulary
from scheduler_tpu_torch.apis.objects import (
    GROUP_NAME_ANNOTATION,
    NodeSpec,
    PodGroup,
    PodGroupPhase,
    PodSpec,
    Queue,
)
from scheduler_tpu_torch.cache.fakes import FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder
from scheduler_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder
from scheduler_tpu_torch.utils import obs

logger = logging.getLogger("scheduler_tpu_torch.cache")


def shadow_pod_group_name(pod: PodSpec) -> str:
    """Name of the synthesized PodGroup for a bare pod (reference cache/util.go:30-63)."""
    return f"podgroup-{pod.uid}"


class SchedulerCache(Cache):
    def __init__(
        self,
        scheduler_name: str = "volcano",
        default_queue: str = "default",
        vocab: Optional[ResourceVocabulary] = None,
        binder: Optional[Binder] = None,
        evictor: Optional[Evictor] = None,
        status_updater: Optional[StatusUpdater] = None,
        volume_binder: Optional[VolumeBinder] = None,
        async_io: bool = True,
        io_workers: Optional[int] = None,
    ) -> None:
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.vocab = vocab if vocab is not None else ResourceVocabulary()

        self.mutex = threading.RLock()
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        # Columnar dynamic node state ([N, R] matrices; nodes hold row views).
        # Sessions snapshot it with one matrix copy instead of N vector clones.
        from scheduler_tpu_torch.api.node_ledger import NodeLedger

        self.node_ledger = NodeLedger(self.vocab.size)
        # Node-spec generation + static-tensor memo: the engines' static node
        # columns (labels/taints/allocatable/...) are pure functions of the
        # node specs, so they cache across cycles until a node event lands.
        self.node_generation: int = 0
        from scheduler_tpu_torch.api.tensors import NodeStaticCache

        self.node_tensor_cache = NodeStaticCache()
        # Per-signature static-mask rows memoized across cycles by the device
        # predicate builder (plugins/predicates.py): {plugin: entry}, each
        # entry keyed by (node generation, widths, pressure checks, device)
        # and dropped wholesale when its key goes stale.
        self.static_mask_cache: Dict[str, dict] = {}
        # Condition-dedupe ledgers (reference podConditionHaveUpdate): the
        # last unschedulable message pushed per pod + a per-job short-circuit
        # signature; pruned on pod delete.
        self._pod_cond_last: Dict[str, str] = {}
        self._job_cond_sig: Dict[str, tuple] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, int] = {}

        # Dirty-set marks: which nodes, jobs and queues changed after a given
        # epoch, so the engine cache's hit path refreshes exactly the churned
        # node rows (ops/fused.py ``_refresh_dynamic``).  Every mutation path
        # marks under the mutex; ``snapshot()`` stamps the epoch onto the
        # ClusterInfo.  Past ``_DIRTY_CAP`` live entries a map clears and its
        # floor advances: queries older than the floor answer "unknown" and
        # the consumer diffs the full tensors instead.  The marks are a
        # superset of real changes (a no-op rewrite still marks); consumers
        # content-compare the marked rows.
        self._dirty_epoch = 0
        self._node_dirty: Dict[str, int] = {}
        self._job_dirty: Dict[str, int] = {}
        self._queue_dirty: Dict[str, int] = {}
        self._node_dirty_floor = 0
        self._job_dirty_floor = 0
        self._queue_dirty_floor = 0

        # Time-to-bind and pending-age clock (utils/obs.py): when a pod is
        # first seen unbound, a monotonic stamp records its arrival.  Bind
        # commits peek a window-tail sample a batch (the seam stays
        # O(window)); pod delete is the one cleanup point.  Updates (delete
        # and add with gc=False) keep the entry, so a watch echo never
        # resets a pod's pending age.
        self._pending_since: Dict[str, float] = {}

        self.binder = binder if binder is not None else FakeBinder()
        self.evictor = evictor if evictor is not None else FakeEvictor()
        self.status_updater = status_updater if status_updater is not None else FakeStatusUpdater()
        self.volume_binder = volume_binder if volume_binder is not None else FakeVolumeBinder()

        self._async_io = async_io
        if io_workers:
            self._IO_WORKERS = io_workers  # per-instance override of the default
        self._io_pool: Optional[ThreadPoolExecutor] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> None:
        if self._async_io and self._io_pool is None:
            self._io_pool = ThreadPoolExecutor(
                max_workers=self._IO_WORKERS, thread_name_prefix="cache-io"
            )
        self._running = True

    def stop(self) -> None:
        self.binder.close()
        if self._io_pool is not None:
            self._io_pool.shutdown(wait=True)
            self._io_pool = None
        self._running = False

    def client(self):
        """The backing API client (the reference's ``Cache.Client()``); None
        unless ``connector.connect_cache`` wired one."""
        return None

    def obs_serving_snapshot(self) -> dict:
        """Scrape-time serving state for ``/metrics``: per-queue pending
        depth and the ages of pending tasks (at most ``obs.TTB_WINDOW`` a
        queue).  One mutex hold a scrape, on the HTTP thread."""
        now = time.monotonic()
        depth: Dict[str, int] = {}
        ages: Dict[str, list] = {}
        pending_val = int(TaskStatus.PENDING)
        with self.mutex:
            for job in self.jobs.values():
                store = job.store
                if store.n == 0:
                    continue
                mask = store.status[: store.n] == pending_val
                count = int(mask.sum())
                if not count:
                    continue
                depth[job.queue] = depth.get(job.queue, 0) + count
                bucket = ages.setdefault(job.queue, [])
                room = obs.TTB_WINDOW - len(bucket)
                if room <= 0:
                    continue
                for uid in store.uids[: store.n][mask][:room].tolist():
                    since = self._pending_since.get(uid)
                    if since is not None:
                        bucket.append(max(0.0, now - since))
        return {"queue_depth": depth, "pending_ages": ages}

    def _submit_io(self, fn, *args) -> None:
        if self._io_pool is not None:
            self._io_pool.submit(fn, *args)
        else:
            fn(*args)

    # -- dirty-set bookkeeping ------------------------------------------------

    # Beyond this many live entries a map, the per-row bookkeeping costs more
    # than the full-tensor diff it replaces: overflow to "unknown".
    _DIRTY_CAP = 8192

    def _mark_dirty(self, table: str, names) -> None:
        """Record that ``names`` of ``table`` mutated.  Callers hold the
        mutex (every call site is a mutation path that already does)."""
        self._dirty_epoch += 1
        epoch = self._dirty_epoch
        d = getattr(self, f"_{table}_dirty")
        for name in names:
            d[name] = epoch
        if len(d) > self._DIRTY_CAP:
            d.clear()
            setattr(self, f"_{table}_dirty_floor", epoch)

    def dirty_nodes_since(self, epoch: int):
        """Names of nodes whose dynamic state may have changed after
        ``epoch`` (a superset: consumers content-compare), or ``None`` when
        the answer is unknown (the epoch predates the map's floor, or none)."""
        with self.mutex:
            if epoch < self._node_dirty_floor or epoch < 0:
                return None
            return {n for n, e in self._node_dirty.items() if e > epoch}

    def dirty_counts_since(self, epoch: int) -> Dict[str, int]:
        """Per-table dirty counts after ``epoch``; -1 = unknown (overflow)."""
        out = {}
        with self.mutex:
            for table in ("node", "job", "queue"):
                if epoch < getattr(self, f"_{table}_dirty_floor") or epoch < 0:
                    out[f"{table}s"] = -1
                    continue
                d = getattr(self, f"_{table}_dirty")
                out[f"{table}s"] = sum(1 for e in d.values() if e > epoch)
        return out

    # -- job/node accessors --------------------------------------------------

    def _get_or_create_job(self, pod: PodSpec) -> Optional[JobInfo]:
        """Find the pod's job, synthesizing a shadow PodGroup for bare pods owned
        by this scheduler (event_handlers.go:42-67)."""
        job_id = job_id_for_pod(pod)
        if not job_id:
            if pod.scheduler_name != self.scheduler_name:
                return None
            # Bare pod scheduled by us: synthesize a single-member gang.
            pg = PodGroup(
                name=shadow_pod_group_name(pod),
                namespace=pod.namespace,
                min_member=1,
                queue=self.default_queue,
                shadow=True,
            )
            pg.status.phase = PodGroupPhase.INQUEUE
            job_id = f"{pg.namespace}/{pg.name}"
            pod.annotations = dict(pod.annotations)
            pod.annotations[GROUP_NAME_ANNOTATION] = pg.name
            job = self.jobs.get(job_id)
            if job is None:
                job = JobInfo(job_id, self.vocab)
                self.jobs[job_id] = job
            if job.pod_group is None:
                job.set_pod_group(pg)
            return job

        job = self.jobs.get(job_id)
        if job is None:
            job = JobInfo(job_id, self.vocab)
            self.jobs[job_id] = job
        return job

    def _get_or_create_node(self, name: str) -> NodeInfo:
        node = self.nodes.get(name)
        if node is None:
            node = NodeInfo(self.vocab)  # un-initialized placeholder (node=None)
            node.name = name
            node.attach(self.node_ledger)
            self.nodes[name] = node
        return node

    # -- pod events ----------------------------------------------------------

    def add_pod(self, pod: PodSpec) -> None:
        with self.mutex:
            self._add_pod_locked(pod)

    def _add_pod_locked(self, pod: PodSpec) -> None:
        job = self._get_or_create_job(pod)
        if job is None:
            return  # not ours
        task = TaskInfo(pod, self.vocab)
        task.job = job.uid
        job.add_task_info(task)
        self._mark_dirty("job", (job.uid,))
        if pod.node_name:
            self._get_or_create_node(pod.node_name).add_task(task)
            self._mark_dirty("node", (pod.node_name,))
            self._pending_since.pop(task.uid, None)
        else:
            # setdefault: an update echo must not reset the pending clock.
            self._pending_since.setdefault(task.uid, time.monotonic())

    def update_pod(self, pod: PodSpec) -> None:
        with self.mutex:
            if self._bind_unechoed_locked(pod):
                return
            # gc=False: an update is delete+add in one breath — GC'ing a
            # shadow job in between would re-synthesize its PodGroup with a
            # fresh creation timestamp on every watch echo, destabilizing
            # job order (and paying a rebuild) for every bare pod.
            self._delete_pod_locked(pod, gc=False)
            self._add_pod_locked(pod)

    def _job_of_pod_locked(self, pod: PodSpec):
        job_id = job_id_for_pod(pod)
        if not job_id:
            # May have been adopted via a shadow PodGroup.
            job_id = f"{pod.namespace}/{shadow_pod_group_name(pod)}"
        return self.jobs.get(job_id)

    def _bind_unechoed_locked(self, pod: PodSpec) -> bool:
        """True when ``pod`` is an unbound view of a task whose bind was sent
        and whose echo has not come back: a relist's LIST or a watch event
        from before the server applied the bind.  Such a view keeps the
        task where it is; the bind's own outcome moves it (its echo, or its
        failure's resync).  Undoing it here would free room that the server
        fills once the bind lands, and let the next cycle place the pod a
        second time.  The JAX package's cache undoes it."""
        if pod.node_name:
            return False
        job = self._job_of_pod_locked(pod)
        row = job.store.row_of.get(pod.uid) if job is not None else None
        return row is not None and job.view_for_row(row).status == TaskStatus.BINDING

    def delete_pod(self, pod: PodSpec) -> None:
        with self.mutex:
            self._delete_pod_locked(pod)

    def _delete_pod_locked(self, pod: PodSpec, gc: bool = True) -> None:
        job = self._job_of_pod_locked(pod)
        self._pod_cond_last.pop(pod.uid, None)
        if gc:
            # A real delete ends the pending clock; the update path keeps it.
            self._pending_since.pop(pod.uid, None)
        if job is not None:
            self._mark_dirty("job", (job.uid,))
            row = job.store.row_of.get(pod.uid)
            task = job.view_for_row(row) if row is not None else None
            if task is not None:
                job.delete_task_info(task)
                if task.node_name and task.node_name in self.nodes:
                    try:
                        self.nodes[task.node_name].remove_task(task)
                    except KeyError:
                        pass
                    self._mark_dirty("node", (task.node_name,))
            if gc:
                self._gc_job(job)

    def _gc_job(self, job: JobInfo) -> None:
        """Drop finished/empty jobs (the reference's deletedJobs GC queue).
        A shadow PodGroup exists only to cover its one bare pod — once the
        pod is gone the synthesized group must die with it, or every churned
        bare pod leaks a permanent empty job into every snapshot."""
        if job.task_count == 0 and (
            job.pod_group is None or job.pod_group.shadow
        ):
            self.jobs.pop(job.uid, None)
            self._job_cond_sig.pop(job.uid, None)

    # -- node events ---------------------------------------------------------

    def add_node(self, node: NodeSpec) -> None:
        with self.mutex:
            self.node_generation += 1
            ni = self._get_or_create_node(node.name)
            ni.set_node(node)
            self._mark_dirty("node", (node.name,))

    def update_node(self, node: NodeSpec) -> None:
        with self.mutex:
            self.node_generation += 1
            ni = self._get_or_create_node(node.name)
            ni.set_node(node)
            self._mark_dirty("node", (node.name,))

    def delete_node(self, node: NodeSpec) -> None:
        with self.mutex:
            self.node_generation += 1
            self.nodes.pop(node.name, None)
            self.node_ledger.detach(node.name)
            self._mark_dirty("node", (node.name,))

    # -- podgroup events ------------------------------------------------------

    def add_pod_group(self, pg: PodGroup) -> None:
        with self.mutex:
            job_id = f"{pg.namespace}/{pg.name}"
            job = self.jobs.get(job_id)
            if job is None:
                job = JobInfo(job_id, self.vocab)
                self.jobs[job_id] = job
            job.set_pod_group(pg)
            self._mark_dirty("job", (job_id,))

    def update_pod_group(self, pg: PodGroup) -> None:
        self.add_pod_group(pg)

    def delete_pod_group(self, pg: PodGroup) -> None:
        with self.mutex:
            job_id = f"{pg.namespace}/{pg.name}"
            job = self.jobs.get(job_id)
            if job is not None:
                job.unset_pod_group()
                self._gc_job(job)
                self._mark_dirty("job", (job_id,))

    # -- queue events ---------------------------------------------------------

    def add_queue(self, queue: Queue) -> None:
        with self.mutex:
            self.queues[queue.name] = QueueInfo(queue)
            self._mark_dirty("queue", (queue.name,))

    def update_queue(self, queue: Queue) -> None:
        self.add_queue(queue)

    def delete_queue(self, queue: Queue) -> None:
        with self.mutex:
            self.queues.pop(queue.name, None)
            self._mark_dirty("queue", (queue.name,))

    # -- priority classes ------------------------------------------------------

    def add_priority_class(self, name: str, value: int) -> None:
        with self.mutex:
            self.priority_classes[name] = value

    def delete_priority_class(self, name: str) -> None:
        with self.mutex:
            self.priority_classes.pop(name, None)

    # -- relist reconciliation --------------------------------------------------

    def prune_absent(
        self,
        pod_uids: Optional[set] = None,
        node_names: Optional[set] = None,
        podgroup_keys: Optional[set] = None,
        queue_names: Optional[set] = None,
        priority_class_names: Optional[set] = None,
        pod_scope: Optional[str] = None,
    ) -> int:
        """Delete every cached object absent from a full LIST of the system
        of record (client-go's store Replace): an object deleted while the
        watch horizon was lost must not stay a ghost holding node resources.
        Shadow PodGroups are local and never pruned (their pods are).

        A ``None`` survivor set leaves that kind untouched (the k8s wire
        relists one resource at a time).  ``pod_scope`` narrows the pod
        prune to one ``spec.nodeName`` partition, ``"assigned"`` or
        ``"unassigned"``: a partition LIST says nothing of the other one.
        A pod with a bind in flight is in neither.  Returns the number of
        objects removed."""
        removed = 0

        def in_scope(task) -> bool:
            if pod_scope is None:
                return True
            if task.status == TaskStatus.BINDING:
                return False
            return bool(task.node_name) == (pod_scope == "assigned")

        with self.mutex:
            if pod_uids is not None or podgroup_keys is not None:
                for job in list(self.jobs.values()):
                    if pod_uids is not None:
                        ghost_pods = [
                            task.pod
                            for task in list(job.tasks.values())
                            if task.pod.uid not in pod_uids and in_scope(task)
                        ]
                        for pod in ghost_pods:
                            self._delete_pod_locked(pod)
                            removed += 1
                    pg = job.pod_group
                    if podgroup_keys is not None and pg is not None \
                            and not pg.shadow and \
                            f"{pg.namespace}/{pg.name}" not in podgroup_keys:
                        self.delete_pod_group(pg)
                        removed += 1
            if node_names is not None:
                for name in list(self.nodes):
                    if name not in node_names:
                        self.node_generation += 1
                        del self.nodes[name]
                        self.node_ledger.detach(name)
                        self._mark_dirty("node", (name,))
                        removed += 1
            if queue_names is not None:
                for name in list(self.queues):
                    if name not in queue_names:
                        del self.queues[name]
                        self._mark_dirty("queue", (name,))
                        removed += 1
            if priority_class_names is not None:
                for name in list(self.priority_classes):
                    if name not in priority_class_names:
                        del self.priority_classes[name]
                        removed += 1
        return removed

    # -- snapshot (cache.go:584-654) -------------------------------------------

    def snapshot(self) -> ClusterInfo:
        from scheduler_tpu_torch.api.node_ledger import LedgerNodeMap

        with self.mutex:
            info = ClusterInfo(self.vocab)
            info.node_generation = self.node_generation
            # The dirty-set epoch at freeze time: the engine cache's hit path
            # asks what changed after the snapshot it last refreshed from.
            info.dirty_epoch = self._dirty_epoch
            # Node state isolation = ONE ledger matrix copy; per-node views
            # materialize lazily (api/node_ledger.py LedgerNodeMap).
            info.nodes = LedgerNodeMap(
                self.node_ledger.clone(),
                dict(self.nodes),
                {name: node.snapshot_bookkeeping() for name, node in self.nodes.items()},
            )
            for name, queue in self.queues.items():
                info.queues[name] = queue.clone()
            for job_id, job in self.jobs.items():
                if job.pod_group is None:
                    logger.debug("job %s skipped in snapshot: missing PodGroup", job_id)
                    continue
                # Build request signatures on the PERSISTENT job so the cache
                # amortizes them across cycles (clones inherit the built refs;
                # building lazily on a clone would be lost at session close).
                # Only jobs with pending tasks sort by signature — a huge
                # all-running job must not pay a build on every churn cycle.
                if job.status_count(TaskStatus.PENDING) and not job.store.sigs_valid():
                    job.store.build_sigs()
                clone = job.clone()
                if clone.pod_group is not None:
                    pc = self.priority_classes.get(clone.pod_group.priority_class_name)
                    if pc is not None:
                        clone.priority = pc
                    # Sessions mutate PodGroup status; give them their own copy.
                    pg = PodGroup(**{
                        "name": clone.pod_group.name,
                        "namespace": clone.pod_group.namespace,
                        "min_member": clone.pod_group.min_member,
                        "queue": clone.pod_group.queue,
                        "priority_class_name": clone.pod_group.priority_class_name,
                        "min_resources": clone.pod_group.min_resources,
                        # Locality must survive the clone: the wire status
                        # updaters skip shadow groups (the server has no
                        # such object to PATCH — connector/client.py).
                        "shadow": clone.pod_group.shadow,
                    })
                    pg.uid = clone.pod_group.uid
                    pg.creation_timestamp = clone.pod_group.creation_timestamp
                    pg.status = clone.pod_group.status.clone()
                    clone.pod_group = pg
                info.jobs[job_id] = clone
            return info

    # -- scheduling side effects (cache.go:404-487) -----------------------------

    def _find_job_and_task(self, ti: TaskInfo):
        job = self.jobs.get(ti.job)
        if job is None:
            raise KeyError(f"failed to find job {ti.job}")
        task = job.tasks.get(ti.uid)
        if task is None:
            raise KeyError(f"failed to find task {ti.uid} in job {ti.job}")
        return job, task

    def bind(self, ti: TaskInfo, hostname: str) -> None:
        """Update local state, then dispatch the bind asynchronously."""
        with self.mutex:
            job, task = self._find_job_and_task(ti)
            node = self.nodes.get(hostname)
            if node is None:
                raise KeyError(f"failed to find node {hostname}")
            job.update_task_status(task, TaskStatus.BINDING)
            task.node_name = hostname
            node.add_task(task)
            self._mark_dirty("node", (hostname,))
            self._mark_dirty("job", (job.uid,))
            age = self._pending_age_peek(task.uid)
        obs.binds_committed(
            [(job.queue, 1, [age] if age is not None else [])]
        )

        self._submit_io(self._bind_one, task, hostname)

    # -- lifecycle events (reference Recorder.Eventf, cache.go:482,440,516) ----

    def _pod_event_batch(self, pods_hosts, etype: str, reason: str, fmt) -> None:
        """ONE batched, best-effort emission per call — payload construction
        AND delivery are both guarded, so an event problem can never be
        mistaken for a bind/evict failure (the callers keep emission outside
        their RPC try blocks for the same reason)."""
        if not getattr(self.status_updater, "RECORDS_EVENTS", False):
            return
        try:
            events = [
                {"namespace": pod.namespace, "name": pod.name, "type": etype,
                 "reason": reason, "message": fmt(pod, host)}
                for pod, host in pods_hosts
            ]
            if events:
                self.status_updater.record_events(events)
        except Exception:
            logger.exception("event emission failed (ignored)")

    @staticmethod
    def _scheduled_msg(pod, host) -> str:
        return f"Successfully assigned {pod.namespace}/{pod.name} to {host}"

    @staticmethod
    def _bind_failed_msg(pod, host) -> str:
        return f"Binding rejected: {pod.namespace}/{pod.name} on {host}"

    def _bind_one(self, task: TaskInfo, hostname: str) -> None:
        try:
            self.binder.bind(task.pod, hostname)
            with self.mutex:
                task.pod.node_name = hostname
        except Exception:
            logger.exception("bind of %s to %s failed; resyncing", task.uid, hostname)
            self._pod_event_batch(
                [(task.pod, hostname)], "Warning", "FailedScheduling",
                self._bind_failed_msg,
            )
            self._resync_failed_bind(task, hostname)
            return
        self._pod_event_batch(
            [(task.pod, hostname)], "Normal", "Scheduled", self._scheduled_msg
        )

    # Upper bound on binder RPCs per async chunk; the actual chunk shrinks so a
    # batch spreads across every io worker (chunk ~ N/workers, floor 16).
    _BIND_CHUNK = 256
    _IO_WORKERS = 8

    def bind_bulk(self, tasks, plan=None) -> None:
        """Batch ``bind``: one mutex hold, vectorized node/job accounting,
        chunked async dispatch (failures resync individually).

        ``plan`` (optional) = CommitPlan.bind_deltas output:
        (node name -> (delta row, count), job uid -> allocated sum) — the
        cache-side accounting then applies precomputed dense rows instead of
        gathering per-task request vectors a second time."""
        from collections import defaultdict

        node_rows, job_rows = plan if plan is not None else ({}, {})
        with self.mutex:
            by_job = defaultdict(list)
            by_node = defaultdict(list)
            resolved = []
            drifted = 0
            # Lookup pass first — no mutation until the batch resolves.  A
            # task whose job or node vanished mid-cycle (watch-thread drift:
            # the session decided on a frozen snapshot) is SKIPPED, not a
            # batch abort: the reference's Bind returns a per-task error and
            # the next snapshot reconciles (cache.go:447-487).
            for ti in tasks:
                try:
                    job, task = self._find_job_and_task(ti)
                except KeyError:
                    drifted += 1
                    continue
                if ti.node_name not in self.nodes:
                    drifted += 1
                    continue
                by_job[job.uid].append((job, task))
                by_node[ti.node_name].append(task)
                resolved.append((task, ti.node_name))
            if drifted:
                logger.warning(
                    "bind batch: %d task(s) skipped, job/node deleted mid-cycle",
                    drifted,
                )
                # The precomputed ledger rows cover the FULL batch; with
                # tasks dropped they would over-account — recompute per task.
                node_rows, job_rows = {}, {}
            for task, hostname in resolved:
                task.node_name = hostname
            for uid, rows in by_job.items():
                rows[0][0].bulk_update_status(
                    [t for _, t in rows], TaskStatus.BINDING,
                    net_add=job_rows.get(uid),
                )
            for hostname, node_tasks in by_node.items():
                agg = None
                if hostname in node_rows:
                    row, count = node_rows[hostname]
                    # Bind batches are allocated-status only: idle -= row,
                    # used += row, releasing untouched.
                    agg = (row, None, row, count, 0)
                self.nodes[hostname].bulk_add_tasks(node_tasks, agg=agg)
            self._mark_dirty("job", by_job)
            self._mark_dirty("node", by_node)
            batches = [
                self._ttb_batch(
                    pairs[0][0].queue,
                    [task.uid for _, task in pairs[-obs.TTB_WINDOW:]],
                    count=len(pairs),
                )
                for pairs in by_job.values()
            ] if obs.enabled() else []
        obs.binds_committed(batches)

        def bind_chunk(chunk) -> None:
            from scheduler_tpu_torch.cache.interface import BulkBindError

            by_uid = {task.pod.uid: (task, hostname) for task, hostname in chunk}
            failed_uids = set()
            try:
                self.binder.bind_bulk([(task.pod, hostname) for task, hostname in chunk])
            except BulkBindError as e:
                # Exactly these pods failed; the rest of the batch applied.
                failed_uids = {pod.uid for pod, _ in e.failed}
            except Exception:
                # Unknown failure mode: assume nothing applied, resync all
                # (cache.go:432-437 semantics: every task reverts).
                logger.exception("bulk bind failed; resyncing chunk")
                failed_uids = set(by_uid)
            with self.mutex:
                for task, hostname in chunk:
                    if task.pod.uid not in failed_uids:
                        task.pod.node_name = hostname
            self._pod_event_batch(
                [(task.pod, hostname) for task, hostname in chunk
                 if task.pod.uid not in failed_uids],
                "Normal", "Scheduled", self._scheduled_msg,
            )
            self._pod_event_batch(
                [(by_uid[uid][0].pod, by_uid[uid][1]) for uid in failed_uids],
                "Warning", "FailedScheduling", self._bind_failed_msg,
            )
            for uid in failed_uids:
                task, hostname = by_uid[uid]
                logger.error("bind of %s to %s failed; resyncing", task.uid, hostname)
                self._resync_failed_bind(task, hostname)

        chunk_size = max(16, min(self._BIND_CHUNK, -(-len(resolved) // self._IO_WORKERS)))
        for start in range(0, len(resolved), chunk_size):
            self._submit_io(bind_chunk, resolved[start : start + chunk_size])

    def _pending_age_peek(self, uid: str) -> Optional[float]:
        """A task's pending age (seconds since first seen unbound), a
        time-to-bind sample at bind commit.  Peek, not pop: the entry must
        survive a failed bind RPC so the eventual bind samples the full
        wait.  None when the task was never registered pending."""
        since = self._pending_since.get(uid)
        if since is None:
            return None
        return max(0.0, time.monotonic() - since)

    def _ttb_batch(self, queue: str, uids, count: Optional[int] = None) -> tuple:
        """One ``(queue, count, ages)`` bind batch for ``obs.binds_committed``:
        ages from at most the window tail of ``uids`` (the reservoir holds
        ``obs.TTB_WINDOW`` a queue).  ``count`` overrides the bind count when
        ``uids`` is already the window tail."""
        if count is None:
            count = len(uids)
        tail = uids[-obs.TTB_WINDOW:] if len(uids) > obs.TTB_WINDOW else uids
        ages = []
        now = time.monotonic()
        for uid in tail:
            since = self._pending_since.get(uid)
            if since is not None:
                ages.append(max(0.0, now - since))
        return (queue, count, ages)

    def _sync_pod_via_client(self, namespace: str, name: str) -> bool:
        """The reference syncTask seam (event_handlers.go:96-114): re-fetch
        one pod from the system of record and rebuild its task.  False when
        no client is wired or the GET failed: callers then revert locally."""
        client = self.client()
        if client is not None and hasattr(client, "sync_pod"):
            return bool(client.sync_pod(namespace, name))
        return False

    def _resync_failed_bind(self, ti: TaskInfo, hostname: str) -> None:
        """A failed bind reverts locally (the task goes back to pending and
        its node gives the resources back), then re-fetches the pod from the
        system of record where there is one.  The revert comes first: it
        ends the task's Binding status, which shields it from unbound views
        (``_bind_unechoed_locked``), the re-fetch's among them."""
        with self.mutex:
            try:
                job, task = self._find_job_and_task(ti)
            except KeyError:
                return
            node = self.nodes.get(hostname)
            if node is not None and task.uid in node.tasks:
                node.remove_task(task)
            task.node_name = ""
            job.update_task_status(task, TaskStatus.PENDING)
            # Back to pending: the arrival entry is still there (bind
            # commits peek, never pop); setdefault covers a task never
            # registered.
            self._pending_since.setdefault(task.uid, time.monotonic())
            self._mark_dirty("node", (hostname,))
            self._mark_dirty("job", (job.uid,))
        self._sync_pod_via_client(ti.namespace, ti.name)

    # -- columnar commit hooks (device-engine extension) --------------------------

    def allocate_volumes_rows(self, job, rows, names) -> None:
        if getattr(self.volume_binder, "NOOP", False) or len(rows) == 0:
            return
        if not job.volume_claim_tasks:
            return  # claim-free job: no per-row materialization, no RPCs
        for r, name in zip(rows, names):
            self.volume_binder.allocate_volumes(job.view_for_row(int(r)), name)

    def bind_volumes_rows(self, job, rows) -> None:
        if getattr(self.volume_binder, "NOOP", False):
            return
        if not job.volume_claim_tasks:
            return
        for r in rows:
            self.volume_binder.bind_volumes(job.view_for_row(int(r)))

    def bind_bulk_columnar(self, items, plan) -> None:
        """Columnar ``bind_bulk``: (session_job, rows, ids) batches applied to
        the cache's own jobs by ROW — valid because the session job clone
        shares the cache job's row space and the store generation proves the
        task set has not drifted since the snapshot.  On any drift the whole
        batch falls back to the uid-resolving object path (same atomic
        semantics).  ``ids`` are the engine node indices per row, so the
        per-node grouping is an integer sort, not a name-string sort.

        ``plan`` = CommitPlan.bind_deltas output (required here — the session
        only routes through this path when the plan covers the batch).
        """
        node_rows, job_rows = plan
        with self.mutex:
            resolved = []
            distinct_nodes = set(node_rows)
            for sjob, rows, ids in items:
                cjob = self.jobs.get(sjob.uid)
                if cjob is None or cjob.store.gen != sjob.store.gen:
                    # Job deleted or task set drifted mid-cycle: resolve the
                    # whole batch by uid (drift-tolerant skip semantics).
                    resolved = None
                    break
                resolved.append((cjob, rows, sjob.store.node_name[rows], ids))
            if resolved is not None and any(
                hostname not in self.nodes for hostname in distinct_nodes
            ):
                resolved = None  # a target node vanished: same fallback
            if resolved is None:
                tasks = [
                    sjob.view_for_row(int(r)) for sjob, rows, _ids in items for r in rows
                ]
                self.bind_bulk(tasks, None)
                return
            from scheduler_tpu_torch.api.job_info import batch_update_status_rows

            # Engine rows are unique per job, the gen match proves no drift
            # (every row is PENDING) — one native scatter for the whole batch.
            batch_update_status_rows([
                (cjob, rows, TaskStatus.BINDING, job_rows.get(cjob.uid),
                 TaskStatus.PENDING)
                for cjob, rows, _names, _ids in resolved
            ])
            for cjob, rows, names, _ids in resolved:
                cjob.set_node_names_rows(rows, names)
            self._mark_dirty("job", (cjob.uid for cjob, *_ in resolved))
            if obs.enabled():
                # O(window) a job, never O(rows).
                obs.binds_committed([
                    self._ttb_batch(
                        cjob.queue,
                        cjob.store.uids[rows[-obs.TTB_WINDOW:]].tolist(),
                        count=len(rows),
                    )
                    for cjob, rows, _names, _ids in resolved
                ])
            # Per-node batches via ONE stable integer argsort across the whole
            # batch; each group's name resolves from its first member.
            ids_all = (
                np.concatenate([ids for *_, ids in resolved])
                if resolved
                else np.zeros(0, dtype=np.int32)
            )
            names_all = cores_all = None
            if ids_all.shape[0]:
                names_all = np.concatenate([names for _, _, names, _ in resolved])
                cores_all = np.concatenate(
                    [cjob.store.cores[rows] for cjob, rows, _, _ in resolved]
                )
                order = np.argsort(ids_all, kind="stable")
                cores_sorted = cores_all[order]
                uniq, starts = np.unique(ids_all[order], return_index=True)
                bounds = starts.tolist() + [order.shape[0]]
                groups = []
                for g in range(uniq.shape[0]):
                    hostname = names_all[order[starts[g]]]
                    groups.append(
                        (hostname, cores_sorted[bounds[g] : bounds[g + 1]])
                    )
                # Bind batches are allocated-status only: idle -= row,
                # used += row, releasing untouched — applied as ONE ledger
                # scatter over every touched node (records append per node;
                # placeholder nodes, whose accounting the object path skips,
                # take the per-node path).
                led = self.node_ledger
                if all(
                    self.nodes[nm].node is not None and nm in led.row_of
                    for nm, _ in groups
                ):
                    delta = np.stack([node_rows[nm][0] for nm, _ in groups])
                    zeros = np.zeros_like(delta)
                    counts = np.asarray(
                        [node_rows[nm][1] for nm, _ in groups], dtype=np.int64
                    )
                    led.apply_node_deltas(
                        np.asarray([led.row_of[nm] for nm, _ in groups], dtype=np.int64),
                        delta, zeros, delta, counts,
                        mins=self.vocab.min_thresholds(),
                    )
                    for nm, members in groups:
                        self.nodes[nm].append_batch_records(
                            [(members, TaskStatus.BINDING)]
                        )
                else:
                    for nm, members in groups:
                        row, count = node_rows[nm]
                        self.nodes[nm].add_deferred_batches(
                            [(members, TaskStatus.BINDING)],
                            (row, None, row, count, 0),
                        )
                self._mark_dirty("node", (nm for nm, _ in groups))

        # Chunk against the WHOLE batch, spanning job boundaries: per-job
        # chunking degenerates to one submission per job (1000 jobs x 100
        # rows), and the fixed per-chunk cost (submit, tolist, mutex) is what
        # the chunking exists to amortize.  The flats are the node-grouping
        # pass's own (pre-argsort) concatenations, built once per batch.
        if cores_all is None:
            return
        total = ids_all.shape[0]
        chunk = max(16, min(self._BIND_CHUNK, -(-total // self._IO_WORKERS)))
        for start in range(0, total, chunk):
            self._submit_io(
                self._bind_chunk_columnar,
                cores_all[start : start + chunk],
                names_all[start : start + chunk],
            )

    def _bind_chunk_columnar(self, cores_arr, names) -> None:
        from scheduler_tpu_torch.cache.interface import BulkBindError

        cores = cores_arr.tolist()
        names_l = names.tolist()
        failed_uids = set()
        try:
            # Columnar seam: cores expose .namespace/.name like PodSpecs do,
            # so no (pod, hostname) pair tuples materialize on the commit path.
            self.binder.bind_rows(cores, names_l)
        except BulkBindError as e:
            failed_uids = {pod.uid for pod, _ in e.failed}
        except Exception:
            logger.exception("bulk bind failed; resyncing chunk")
            failed_uids = {core.uid for core in cores}
        with self.mutex:
            if failed_uids:
                for core, hostname in zip(cores, names_l):
                    if core.uid not in failed_uids:
                        core.pod.node_name = hostname
            else:
                for core, hostname in zip(cores, names_l):
                    core.pod.node_name = hostname
        self._pod_event_batch(
            ((core.pod, hostname) for core, hostname in zip(cores, names_l)
             if core.uid not in failed_uids),
            "Normal", "Scheduled", self._scheduled_msg,
        )
        if failed_uids:
            self._pod_event_batch(
                ((core.pod, hostname) for core, hostname in zip(cores, names_l)
                 if core.uid in failed_uids),
                "Warning", "FailedScheduling", self._bind_failed_msg,
            )
            for core, hostname in zip(cores, names_l):
                if core.uid not in failed_uids:
                    continue
                logger.error("bind of %s to %s failed; resyncing", core.uid, hostname)
                with self.mutex:
                    cjob = self.jobs.get(core.job)
                    row = (
                        cjob.store.row_of.get(core.uid) if cjob is not None else None
                    )
                    task = cjob.view_for_row(row) if row is not None else None
                if task is not None:
                    self._resync_failed_bind(task, hostname)

    def evict_bulk(self, tis, reason: str):
        """Batched ``evict``: ONE mutex hold for the whole batch's local
        bookkeeping — per-job status-row writes, one releasing-add per node —
        then the eviction RPCs dispatch in worker-sized chunks with a single
        batched Evict event emission per chunk.  Per-RPC failure keeps
        ``do_evict``'s exact semantics: resync the pod from the system of
        record, else restore RUNNING locally.  Returns the input tasks
        that were found in the cache (RPC failures self-repair async, as the
        reference's fire-and-forget eviction goroutines do)."""
        found = []
        with self.mutex:
            slow = []  # cache status changed since the session snapshot
            for ti in tis:
                try:
                    job, task = self._find_job_and_task(ti)
                except KeyError:
                    logger.warning("evict_bulk: task %s not in cache", ti.uid)
                    continue
                found.append((job, task, ti))
                if task.status != TaskStatus.RUNNING:
                    slow.append((job, task))
            slow_ids = {id(t) for _, t in slow}
            fast = [(j, t) for j, t, _ in found if id(t) not in slow_ids]
            rows_by_job: dict = {}
            for job, task in fast:
                entry = rows_by_job.setdefault(id(job), (job, []))
                entry[1].append(job.store.row_of[task.uid])
            for job, rows in rows_by_job.values():
                job.bulk_update_status_rows(
                    np.asarray(rows, dtype=np.int64),
                    TaskStatus.RELEASING,
                    assume_from=TaskStatus.RUNNING,
                )
            tasks_by_node: dict = {}
            for _, task in fast:
                if task.node_name and task.node_name in self.nodes:
                    tasks_by_node.setdefault(task.node_name, []).append(task)
            for name, ts in tasks_by_node.items():
                self.nodes[name].bulk_release_tasks(ts, strict=False)
            self._mark_dirty("node", tasks_by_node)
            self._mark_dirty("job", {job.uid for job, _, _ in found})
            # A victim whose LIVE cache status moved between the session
            # snapshot and this commit (informer event: e.g. a deletion
            # already marked it RELEASING) takes the generic transition the
            # per-task evict used — correct for any prior status.
            for job, task in slow:
                job.update_task_status(task, TaskStatus.RELEASING)
                if task.node_name and task.node_name in self.nodes:
                    node = self.nodes[task.node_name]
                    if task.uid in node.tasks:
                        node.update_task(task)
                        self._mark_dirty("node", (task.node_name,))
        obs.evictions_committed(len(found))
        if not found:
            return []
        chunk = max(16, min(self._BIND_CHUNK, -(-len(found) // self._IO_WORKERS)))
        for start in range(0, len(found), chunk):
            self._submit_io(self._evict_rpc_batch(found[start:start + chunk], reason))
        return [ti for _, _, ti in found]

    def _evict_rpc_batch(self, batch, reason: str):
        """The RPC half of ``evict_bulk`` for one chunk, run on the IO pool."""

        def run() -> None:
            emitted = []
            for _job, task, ti in batch:
                try:
                    self.evictor.evict(task.pod)
                except Exception:
                    logger.exception("evict of %s failed; resyncing", task.uid)
                    if self._sync_pod_via_client(task.namespace, task.name):
                        continue
                    with self.mutex:
                        try:
                            job2, task2 = self._find_job_and_task(ti)
                        except KeyError:
                            continue
                        job2.update_task_status(task2, TaskStatus.RUNNING)
                        self._mark_dirty("job", (job2.uid,))
                        if task2.node_name and task2.node_name in self.nodes:
                            node2 = self.nodes[task2.node_name]
                            if task2.uid in node2.tasks:
                                node2.update_task(task2)
                                self._mark_dirty("node", (task2.node_name,))
                    continue
                emitted.append((task.pod, task.node_name))
            if emitted:
                self._pod_event_batch(
                    emitted, "Normal", "Evict",
                    lambda p, h: f"Evicted pod {p.namespace}/{p.name} ({reason})",
                )

        return run

    def evict(self, ti: TaskInfo, reason: str) -> None:
        """Mark releasing locally, then dispatch the eviction asynchronously."""
        with self.mutex:
            job, task = self._find_job_and_task(ti)
            job.update_task_status(task, TaskStatus.RELEASING)
            self._mark_dirty("job", (job.uid,))
            if task.node_name and task.node_name in self.nodes:
                node = self.nodes[task.node_name]
                if task.uid in node.tasks:
                    node.update_task(task)
                    self._mark_dirty("node", (task.node_name,))
        obs.evictions_committed(1)

        def do_evict() -> None:
            try:
                self.evictor.evict(task.pod)
            except Exception:
                logger.exception("evict of %s failed; resyncing", task.uid)
                if self._sync_pod_via_client(task.namespace, task.name):
                    return
                with self.mutex:
                    try:
                        job2, task2 = self._find_job_and_task(ti)
                    except KeyError:
                        return
                    job2.update_task_status(task2, TaskStatus.RUNNING)
                    self._mark_dirty("job", (job2.uid,))
                    if task2.node_name and task2.node_name in self.nodes:
                        node2 = self.nodes[task2.node_name]
                        if task2.uid in node2.tasks:
                            node2.update_task(task2)
                            self._mark_dirty("node", (task2.node_name,))
                return
            # Event emission stays OUTSIDE the try: a recorder problem must
            # never roll back an eviction that actually happened.
            self._pod_event_batch(
                [(task.pod, task.node_name)], "Normal", "Evict",
                lambda p, h: f"Evicted pod {p.namespace}/{p.name} ({reason})",
            )

        self._submit_io(do_evict)

    def update_job_status(self, job: JobInfo, update_pg: bool = True) -> Optional[JobInfo]:
        """Record unschedulable events and push a recomputed PodGroup status
        (reference cache.go UpdateJobStatus + defaultStatusUpdater)."""
        self.record_job_status_event(job)
        if update_pg:
            with self.mutex:
                cached = self.jobs.get(job.uid)
                if cached is not None and cached.pod_group is not None:
                    cached.pod_group.status = job.pod_group.status.clone()
            self.status_updater.update_pod_group(job)
        return job

    def record_job_status_event(self, job: JobInfo) -> None:
        """Emit unschedulable conditions for unscheduled tasks (cache.go:500-525).

        Conditions DEDUPE like the reference's ``podConditionHaveUpdate``
        (an API PATCH only goes out when the condition actually changed):
        per-pod last-pushed messages are remembered, and a whole job
        short-circuits when its message and task set are unchanged — a
        steady unschedulable backlog costs O(jobs), not O(pods), per cycle."""
        if not job.status_count(TaskStatus.PENDING):
            return  # nothing unscheduled; skip without materializing views
        base_msg = job.job_fit_errors or ALL_NODE_UNAVAILABLE
        records_events = getattr(self.status_updater, "RECORDS_EVENTS", False)
        st = job.store
        # status_gen covers in-place status writes (resync back to PENDING
        # etc.) that the task-set generation does not see.
        sig = (base_msg, st.gen, st.status_gen)
        if (
            not job.nodes_fit_errors
            and not records_events
            and self._job_cond_sig.get(job.uid) == sig
        ):
            return
        if not job.nodes_fit_errors:
            self._job_cond_sig[job.uid] = sig
        else:
            self._job_cond_sig.pop(job.uid, None)
        events = []
        last = self._pod_cond_last
        rows = np.nonzero(st.status[: st.n] == int(TaskStatus.PENDING))[0]
        for row in rows.tolist():
            uid = st.uids[row]
            fe = job.nodes_fit_errors.get(uid)
            msg = fe.error() if fe is not None else base_msg
            if last.get(uid) != msg:
                last[uid] = msg
                self.status_updater.update_pod_condition(
                    st.cores[row].pod,
                    {"type": "PodScheduled", "status": "False",
                     "reason": "Unschedulable", "message": msg},
                )
            if records_events:
                core = st.cores[row]
                events.append({
                    "namespace": core.namespace, "name": core.name,
                    "type": "Warning", "reason": "FailedScheduling",
                    "message": msg,
                })
        if events:
            try:
                self.status_updater.record_events(events)
            except Exception:
                logger.exception("event emission failed (ignored)")

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)
