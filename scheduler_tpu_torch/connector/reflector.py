"""Kubernetes-conformant ingestion: per-resource LIST+WATCH reflectors.

This is the inbound half a REAL API server could feed (``SCHEDULER_TORCH_WIRE=
k8s``; docs/INGEST.md).  It ingests cluster state the way client-go's
reflectors do for the reference's cache (cache/cache.go:256-336 builds one
informer per resource type):

* **LIST** per resource — ``GET /api/v1/pods`` (and ``/api/v1/nodes``,
  ``/apis/scheduling.incubator.k8s.io/v1alpha1/podgroups`` …) returning a
  ``{Kind}List`` envelope whose ``metadata.resourceVersion`` is the watch
  cursor.
* **WATCH** per resource — ``GET {path}?watch=1&resourceVersion=RV&
  timeoutSeconds=T&allowWatchBookmarks=true``, a chunked stream of
  newline-delimited ``{"type": ADDED|MODIFIED|DELETED|BOOKMARK|ERROR,
  "object": …}`` events.  Applied events and BOOKMARKs advance the cursor
  (``wire.obj_rv``); the stream's server-side timeout ends in a bookmark and
  the client reconnects from its cursor.
* **410 Gone** — the server's watch history is bounded; a cursor older than
  its compaction horizon gets HTTP 410 (or a mid-stream ERROR event whose
  Status object carries ``code: 410``).  Recovery is client-go's
  relist-and-replace: re-LIST the resource, upsert everything, and prune
  cached objects the LIST no longer carries — an object deleted during the
  horizon gap must not survive as a ghost holding node resources.

Events feed the existing ``SchedulerCache`` through the SAME ``_apply`` seam
the journal client uses (``client.ConnectorBase``), so the two protocols are
bind-for-bind interchangeable — pinned by the journal-vs-k8s parity test.
Initial LISTs and every relist pay the shared connector ``TokenBucket``;
watch streams deliberately do not (see ``client.connect_cache``).  All retry
paths back off with jittered exponential delays (``client.Backoff``).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from typing import List, Optional

from scheduler_tpu_torch.cache.cache import SchedulerCache
from scheduler_tpu_torch.connector.client import (
    Backoff,
    ConnectorBase,
    TokenBucket,
    _get,
    _get_sized,
)
from scheduler_tpu_torch.connector.wire import (
    LIST_RESOURCES,
    WATCH_OPS,
    obj_name,
    obj_rv,
    object_path,
    pod_key,
    pod_uid,
)

logger = logging.getLogger("scheduler_tpu_torch.connector.reflector")

# The two spec.nodeName watch partitions (docs/TENANT.md "Sharded watch
# ingestion"): the SAME field selectors the split relist uses,
# URL-encoded ("!=" assigned / "=" unassigned).  Together they cover every
# pod exactly once — the selector is a partition of the pod inventory.
POD_WATCH_SHARDS = (
    ("assigned", "spec.nodeName%21%3D"),
    ("unassigned", "spec.nodeName%3D"),
)


def watch_shards() -> int:
    """Pod watch-stream shard count (SCHEDULER_TORCH_WATCH_SHARDS): >= 2
    splits the pod watch into the spec.nodeName partitions, one reflector
    thread + resourceVersion cursor each.  The selector vocabulary has
    exactly two partitions, so any value past 2 still yields two shards."""
    from scheduler_tpu_torch.utils.envflags import env_int

    return env_int("SCHEDULER_TORCH_WATCH_SHARDS", 1, minimum=1)


class WatchExpired(Exception):
    """The server compacted its watch history past our cursor (``410 Gone``,
    at the HTTP layer or as a mid-stream ERROR Status event): the stream is
    unrecoverable and the resource must relist-and-replace."""


class Reflector:
    """One resource's LIST+WATCH loop (client-go ``Reflector``): owns the
    resourceVersion cursor, the per-resource backoff, and the dirty flag
    that demotes the stream to a relist."""

    def __init__(self, conn: "K8sApiConnector", kind: str, path: str,
                 watch_timeout: float = 5.0,
                 shard: Optional[str] = None) -> None:
        self.conn = conn
        self.kind = kind
        self.path = path
        self.watch_timeout = watch_timeout
        self.rv = 0
        self.synced = threading.Event()
        self.backoff = Backoff()
        # An event failed to apply beyond single-object repair (or a watch
        # expired): this resource alone relists — the other reflectors'
        # streams keep flowing.
        self.dirty = False
        self.relists = 0  # replace-relists performed (evidence for tests)
        # Ingest evidence (docs/INGEST.md "Field-selector relists"): every
        # LIST this reflector paid, in bytes, plus the last relist's
        # request-by-request breakdown.
        self.relist_bytes = 0
        self.last_relist: dict = {}
        # Sharded pod watch (SCHEDULER_TORCH_WATCH_SHARDS, docs/TENANT.md):
        # this reflector owns ONE spec.nodeName partition — its LISTs and
        # its watch stream carry the partition selector, its cursor is the
        # partition's own resourceVersion, and a 410 on this shard relists
        # and prunes ONLY this partition while the sibling keeps streaming.
        self.shard = shard
        self.selector = dict(POD_WATCH_SHARDS).get(shard) if shard else None
        # Pod relists partition by spec.nodeName field selector so a 410
        # recovery stops paying one full-cluster payload; a server that
        # 400s the selector (pre-selector conformance targets) demotes this
        # reflector to classic full relists permanently.  A shard reflector
        # is already partition-scoped — its plain LIST carries the selector.
        self.split_relists = kind == "pod" and shard is None

    # -- LIST ----------------------------------------------------------------

    def list_and_replace(self) -> None:
        """LIST the resource; first call seeds, later calls REPLACE: upsert
        every listed object and prune cached ones the LIST no longer carries
        (client-go store Replace — ghosts from the horizon gap die here).

        Pod REPLACE relists partition the inventory with ``spec.nodeName``
        field selectors (``_split_relist``) so 410 recovery pays two
        partition payloads instead of one full-cluster body; the initial
        seed stays a single LIST (nothing cached yet to prune, and the
        dependency-ordered boot wants one request per resource)."""
        replace = self.synced.is_set()
        if replace and self.split_relists and self._split_relist():
            return
        if self.conn.limiter is not None:
            # The full-inventory burst pays the shared QPS budget; the
            # watch stream below does not (client.connect_cache docstring).
            self.conn.limiter.acquire()
        path = self.path
        if self.selector is not None:
            # Shard reflectors LIST their own partition only — seed AND
            # replace — so the cursor below is the partition's own RV.
            path = f"{path}?fieldSelector={self.selector}"
        doc, nbytes = _get_sized(self.conn.base, path)
        items = doc.get("items", []) or []
        rv = obj_rv(doc)
        op = "update" if replace else "add"
        # Clear the flag BEFORE applying (the journal wire's ordering): an
        # apply that diverges DURING this relist re-marks the resource dirty
        # and the run loop relists again — clearing afterwards would swallow
        # that divergence and resume watching over a known-bad cache.
        self.dirty = False
        self.relist_bytes += nbytes
        for item in items:
            self.conn._apply(self.kind, op, item)
        if replace:
            self.conn._prune_kind(self.kind, items, pod_scope=self.shard)
            self.relists += 1
            self.last_relist = {
                "split": False, "bytes": [nbytes], "items": [len(items)],
                **({"shard": self.shard} if self.shard else {}),
            }
        if rv is not None:
            self.rv = rv
        self.synced.set()

    def _split_relist(self) -> bool:
        """Partitioned pod REPLACE: LIST ``spec.nodeName!=`` (assigned)
        then ``spec.nodeName=`` (unassigned), each applied and pruned
        WITHIN its own partition (``prune_absent(pod_scope=...)``) — a
        partition LIST is only authoritative about its own partition.

        Assigned first: a pod bound during the horizon gap appears in the
        assigned LIST and upserts to bound BEFORE the unassigned partition
        is pruned, so it can never be transiently deleted.  The cursor
        advances to the FIRST list's resourceVersion — events landing
        between the two LISTs replay on reconnect, and replays are
        idempotent; resuming from the second RV would skip them.

        Returns False (caller falls back to the classic full relist) when
        the server rejects the field selector — the selector demotion is
        permanent for this reflector."""
        try:
            if self.conn.limiter is not None:
                self.conn.limiter.acquire()
            sel = f"{self.path}?fieldSelector=spec.nodeName"
            self.dirty = False
            doc_a, bytes_a = _get_sized(self.conn.base, sel + "%21%3D")  # !=
            if self.conn.limiter is not None:
                self.conn.limiter.acquire()
            doc_u, bytes_u = _get_sized(self.conn.base, sel + "%3D")  # =
        except urllib.error.HTTPError as e:
            if e.code == 400:
                logger.warning(
                    "%s server rejects spec.nodeName field selectors; "
                    "falling back to full relists", self.kind,
                )
                self.split_relists = False
                return False
            raise
        rv = obj_rv(doc_a)
        for doc, scope in ((doc_a, "assigned"), (doc_u, "unassigned")):
            items = doc.get("items", []) or []
            for item in items:
                self.conn._apply(self.kind, "update", item)
            self.conn._prune_kind(self.kind, items, pod_scope=scope)
        self.relists += 1
        self.relist_bytes += bytes_a + bytes_u
        self.last_relist = {
            "split": True, "bytes": [bytes_a, bytes_u],
            "items": [len(doc_a.get("items") or []),
                      len(doc_u.get("items") or [])],
        }
        if rv is not None:
            self.rv = rv
        self.synced.set()
        return True

    # -- WATCH ---------------------------------------------------------------

    def _watch_url(self) -> str:
        url = (
            f"{self.conn.base}{self.path}?watch=1&resourceVersion={self.rv}"
            f"&timeoutSeconds={max(1, int(self.watch_timeout))}"
            f"&allowWatchBookmarks=true"
        )
        if self.selector is not None:
            # The sharded stream: the server filters events to this
            # spec.nodeName partition (post-state match — a pod binding
            # lands as an event on the shard it newly matches).
            url += f"&fieldSelector={self.selector}"
        return url

    def watch_once(self) -> None:
        """One watch stream: connect at the cursor, apply chunked events
        until the server closes the window (bookmark) or the stream dies.
        Raises ``WatchExpired`` on ``410 Gone`` in either envelope."""
        try:
            resp = urllib.request.urlopen(
                self._watch_url(), timeout=self.watch_timeout + 30.0
            )
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise WatchExpired(f"{self.kind} watch cursor {self.rv}") from e
            raise
        with resp:
            for raw in resp:
                raw = raw.strip()
                if not raw:
                    continue
                self.handle_event(json.loads(raw))
                if self.dirty or self.conn._stop.is_set():
                    # Divergence (or shutdown): stop consuming, relist.
                    return

    def handle_event(self, event: dict) -> None:
        """Apply ONE decoded watch event; the golden-stream fixtures drive
        this directly.  Duplicate echoes are harmless by construction: the
        cache's event handlers upsert by wire uid, so re-applying an event
        is idempotent and the cursor max() ignores stale RVs."""
        etype = event.get("type", "")
        obj = event.get("object") or {}
        if etype == "BOOKMARK":
            rv = obj_rv(obj)
            if rv is not None:
                self.rv = max(self.rv, rv)
            return
        if etype == "ERROR":
            # A Status object; code 410 == "resourceVersion too old".
            if int(obj.get("code", 0)) == 410:
                raise WatchExpired(f"{self.kind} stream ERROR status")
            logger.warning("%s watch ERROR event: %s", self.kind, obj)
            return
        op = WATCH_OPS.get(etype)
        if op is None:
            logger.warning("unknown %s watch event type %r", self.kind, etype)
            return
        self.conn._apply(self.kind, op, obj)
        rv = obj_rv(obj)
        if rv is not None:
            self.rv = max(self.rv, rv)

    # -- the per-resource loop ----------------------------------------------

    def run(self) -> None:
        stop = self.conn._stop
        while not stop.is_set():
            if self.dirty or not self.synced.is_set():
                try:
                    self.list_and_replace()
                    self.backoff.reset()
                except Exception:
                    if stop.is_set():
                        return
                    logger.warning(
                        "%s relist failed; backing off", self.kind,
                        exc_info=True,
                    )
                    stop.wait(self.backoff.next())
                continue
            try:
                self.watch_once()
                self.backoff.reset()
            except WatchExpired:
                logger.warning(
                    "%s watch expired (410 Gone); relist-and-replace",
                    self.kind,
                )
                self.dirty = True
            except Exception:
                if stop.is_set():
                    return
                logger.warning(
                    "%s watch stream failed; backing off", self.kind,
                    exc_info=True,
                )
                stop.wait(self.backoff.next())


class K8sApiConnector(ConnectorBase):
    """The reflector subsystem: one ``Reflector`` per resource, seeded in
    dependency order (queues/priority classes before groups before pods —
    the journal's list_and_seed order), then one watch-stream thread per
    resource.  Same public surface as the journal ``ApiConnector``:
    ``start`` / ``wait_for_cache_sync`` / ``stop`` / ``sync_pod``."""

    def __init__(self, cache: SchedulerCache, base: str,
                 limiter: Optional[TokenBucket] = None,
                 watch_timeout: float = 5.0) -> None:
        super().__init__(cache, base, limiter)
        self.reflectors: List[Reflector] = []
        for kind, path, _ in LIST_RESOURCES:
            if kind == "pod" and watch_shards() >= 2:
                # Sharded pod ingestion (docs/TENANT.md): one reflector
                # thread + cursor per spec.nodeName partition, all feeding
                # the same _apply seam.
                self.reflectors.extend(
                    Reflector(self, kind, path, watch_timeout=watch_timeout,
                              shard=shard)
                    for shard, _sel in POD_WATCH_SHARDS
                )
            else:
                self.reflectors.append(
                    Reflector(self, kind, path, watch_timeout=watch_timeout)
                )
        # kind -> primary reflector (the single instance when unsharded;
        # the first shard otherwise — divergence routing fans out below).
        self._by_kind = {}
        for r in self.reflectors:
            self._by_kind.setdefault(r.kind, r)
        self._threads: List[threading.Thread] = []
        self._boot: Optional[threading.Thread] = None

    # -- divergence routing --------------------------------------------------

    def _mark_dirty(self, kind: str) -> None:
        # Only the affected RESOURCE relists — per-kind stores are exactly
        # what per-resource reflectors buy over the global journal.  A
        # divergence cannot name its partition, so EVERY shard of the kind
        # relists (each prunes only its own partition).
        dirtied = False
        for r in self.reflectors:
            if r.kind == kind:
                r.dirty = True
                dirtied = True
        if not dirtied:  # unknown kind: cannot scope the damage
            self._dirty = True

    def _prune_kind(self, kind: str, items: list,
                    pod_scope: Optional[str] = None) -> None:
        """Replace semantics for ONE kind: everything cached but absent from
        the fresh LIST is a ghost.  Uses the cache's relist reconciler with
        only this kind's survivor set (None == kind untouched); the pod set
        keys by wire uid — the SAME identity rule ``parse_pod`` uses
        (wire.pod_uid), or live pods would be pruned as ghosts.
        ``pod_scope`` narrows a pod prune to one spec.nodeName partition
        (the split-relist path — a partition LIST must not prune the other
        partition's pods)."""
        kw = {}
        if kind == "pod":
            kw["pod_uids"] = {pod_uid(p) for p in items}
            if pod_scope is not None:
                kw["pod_scope"] = pod_scope
        elif kind == "node":
            kw["node_names"] = {obj_name(n) for n in items}
        elif kind == "podgroup":
            kw["podgroup_keys"] = {pod_key(g) for g in items}
        elif kind == "queue":
            kw["queue_names"] = {obj_name(q) for q in items}
        elif kind == "priorityclass":
            kw["priority_class_names"] = {obj_name(pc) for pc in items}
        else:
            return
        removed = self.cache.prune_absent(**kw)
        if removed:
            logger.warning("%s relist pruned %d ghost objects", kind, removed)

    # -- single-object re-fetch (syncTask seam) ------------------------------

    def get_object(self, kind: str, key: str) -> Optional[dict]:
        try:
            return _get(self.base, object_path(kind, key), timeout=10.0)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    # -- lifecycle -----------------------------------------------------------

    def _run(self) -> None:
        # Initial LISTs sequentially, in dependency order, each retried with
        # backoff (the daemon and its system of record start concurrently in
        # any orchestrated deploy — a refused connection at boot must
        # resync, not crash).
        for r in self.reflectors:
            while not self._stop.is_set() and not r.synced.is_set():
                try:
                    r.list_and_replace()
                    r.backoff.reset()
                except Exception:
                    if self._stop.is_set():
                        return
                    logger.warning(
                        "initial %s LIST failed; retrying", r.kind,
                        exc_info=True,
                    )
                    self._stop.wait(r.backoff.next())
        if self._stop.is_set():
            return
        self.synced.set()
        for r in self.reflectors:
            name = f"reflector-{r.kind}" + (f"-{r.shard}" if r.shard else "")
            t = threading.Thread(target=r.run, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def start(self) -> None:
        self._boot = threading.Thread(
            target=self._run, name="reflector-boot", daemon=True
        )
        self._boot.start()

    def stop(self) -> None:
        self._stop.set()
        if self._boot is not None:
            self._boot.join(timeout=10)
        for t in self._threads:
            # Streams notice the stop flag at their next event/bookmark; the
            # server's stream timeout bounds that wait.
            t.join(timeout=10)
        self._close_status_updater()
