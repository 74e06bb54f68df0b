"""Mock API server: the system-of-record process for connector e2e tests.

Stands in for the reference's Kubernetes API server (the scheduler's only
communication backend, SURVEY §2.1): holds the authoritative object store and
accepts the scheduler's side effects (``POST /bind | /bind-bulk | /evict |
/pod-condition | /podgroup-status`` and their k8s-dialect twins).  Binds
mutate the store and are echoed back on the watch stream as pod updates —
the informer echo that makes the scheduler's cache converge on the server's
truth.

Ingestion is served in BOTH wire protocols (docs/INGEST.md) over one store
and one monotonic version counter:

* journal — LIST ``GET /state`` + WATCH ``GET /watch?since=N`` long-poll;
* k8s apiserver mode — per-resource LIST (``GET /api/v1/pods`` …) returning
  ``{Kind}List`` envelopes with ``metadata.resourceVersion``, plus chunked
  WATCH streams (``?watch=1&resourceVersion=RV``) of newline-delimited
  ADDED/MODIFIED/DELETED events, BOOKMARK emission at stream close
  (``allowWatchBookmarks=true``), and real ``410 Gone`` Status objects —
  at the HTTP layer for cursors behind the bounded history's compaction
  horizon, and as mid-stream ERROR events — which must drive the
  reflector's relist-and-replace recovery.

Failure injection (``POST /inject {"op": "bind", "times": K}``) makes the
next K bind calls fail with HTTP 500, which must drive the scheduler's
resync-and-retry path (reference errTasks queue, cache.go:559-581).  The
ingest-side injections: ``{"op": "watch-gone:pod", "times": 1}`` ends the
next pod watch window with an ERROR 410; ``{"op": "compact-history"}``
drops the whole journal (etcd compaction analogue — every cursor behind
``seq`` now 410s); ``{"op": "silent-delete", "kind": "pod", "key":
"ns/name"}`` removes an object WITHOUT a journal event, manufacturing
exactly the ghost a relist must prune.

Run standalone:  python -m scheduler_tpu_torch.connector.mock_server --port 18200
(``--port 0`` binds a free port and prints it).  The port's own copy of
``scheduler_tpu/connector/mock_server.py``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from scheduler_tpu_torch.connector.wire import LIST_RESOURCES

# kind -> (collection path, item Kind); the reflector wire's routing table.
_K8S_COLLECTIONS = {path: (kind, k8s_kind) for kind, path, k8s_kind in LIST_RESOURCES}

_WATCH_TYPE_OF = {"add": "ADDED", "update": "MODIFIED", "delete": "DELETED"}


def _gone_status() -> Dict:
    """The Status object a real apiserver sends for an expired cursor."""
    return {
        "kind": "Status", "apiVersion": "v1", "status": "Failure",
        "reason": "Expired", "message": "too old resource version",
        "code": 410,
    }


def _with_rv(obj: Dict, seq: int) -> Dict:
    """Deep-copy ``obj`` with its wire resourceVersion stamped where the
    client's ``wire.obj_rv`` looks for it (metadata for k8s-shaped docs,
    top-level for the compact dialect)."""
    obj = json.loads(json.dumps(obj))
    if isinstance(obj.get("metadata"), dict):
        obj["metadata"]["resourceVersion"] = str(seq)
    else:
        obj["resourceVersion"] = str(seq)
    return obj


def _pod_node_name(obj: Dict) -> str:
    """A stored pod's node assignment, in either wire dialect."""
    if isinstance(obj.get("metadata"), dict):
        return str((obj.get("spec") or {}).get("nodeName", "") or "")
    return str(obj.get("nodeName", "") or "")


def _parse_field_selector(raw: Optional[str]):
    """The ``fieldSelector`` subset a real apiserver supports on pod LISTs
    that this mock implements: ``spec.nodeName=V`` / ``spec.nodeName==V`` /
    ``spec.nodeName!=V`` (V may be empty — the unassigned partition).
    Returns ``(op, value)`` with op in ``{"=", "!="}``, None when absent,
    or raises ValueError on anything else (the real server 400s too)."""
    if raw is None:
        return None
    field = "spec.nodeName"
    for prefix, op in ((f"{field}!=", "!="), (f"{field}==", "="),
                       (f"{field}=", "=")):
        if raw.startswith(prefix):
            return op, raw[len(prefix):]
    raise ValueError(f"unsupported fieldSelector {raw!r}")


def _k8s_object_route(path: str) -> Optional[Tuple[str, str]]:
    """Single-object GET routing for the k8s wire (the syncTask re-fetch
    shape): path -> (kind, store key), or None."""
    parts = [p for p in path.strip("/").split("/") if p]
    if parts[:3] == ["api", "v1", "nodes"] and len(parts) == 4:
        return "node", parts[3]
    if (
        parts[:3] == ["api", "v1", "namespaces"] and len(parts) == 6
        and parts[4] == "pods"
    ):
        return "pod", f"{parts[3]}/{parts[5]}"
    if parts[:3] == ["apis", "scheduling.incubator.k8s.io", "v1alpha1"]:
        rest = parts[3:]
        if len(rest) == 2 and rest[0] == "queues":
            return "queue", rest[1]
        if len(rest) == 4 and rest[0] == "namespaces" and rest[2] == "podgroups":
            return "podgroup", f"{rest[1]}/{rest[3]}"
    if (
        parts[:3] == ["apis", "scheduling.k8s.io", "v1"] and len(parts) == 5
        and parts[3] == "priorityclasses"
    ):
        return "priorityclass", parts[4]
    return None


class MockState:
    def __init__(self) -> None:
        self.lock = threading.Condition()
        self.objects: Dict[str, Dict[str, Dict]] = {
            "queue": {}, "node": {}, "podgroup": {}, "pod": {},
            "priorityclass": {},
        }
        self.events: List[Dict] = []  # {seq, kind, op, object}
        self.seq = 0
        # Highest seq swallowed by history truncation (etcd's compaction
        # revision): any watch cursor <= a swallowed event is unrecoverable
        # and gets the relist signal (journal: {"relist": true}; k8s wire:
        # a real 410 Gone).
        self.compacted_through = 0
        self.fail: Dict[str, int] = {}  # op -> remaining injected failures
        self.bind_calls = 0
        self.evict_calls = 0
        # Ordered record of every APPLIED bind (pod key, node, monotonic
        # receive time) — the journal-vs-k8s parity tests compare the
        # key/node sequences bitwise; the preempt-storm bench
        # (harness/preempt_storm.py) reads the ``t`` stamps for per-pod
        # arrival-to-bind latency.
        self.bind_log: List[Dict] = []
        # Ordered record of every APPLIED eviction (pod key, monotonic
        # receive time) — the preempt-storm artifact's evictions/s and
        # churn-amplification evidence.
        self.evict_log: List[Dict] = []
        # Wire-shape accounting: how many mutations arrived as real k8s API
        # calls vs the legacy bespoke RPCs — lets tests assert WHICH dialect
        # actually crossed the wire, not just that state changed.
        self.k8s_calls = 0
        self.legacy_calls = 0
        self.get_calls = 0   # single-object re-fetches (syncTask analogue)
        self.list_calls = 0  # full LISTs (relists show up here)
        # Per-LIST evidence: kind, fieldSelector, payload bytes, item count
        # (k8s endpoints only) — the split-relist tests assert 410 recovery
        # stopped paying full-cluster payloads.
        self.list_log: List[Dict] = []
        self.status_updates: List[Dict] = []
        self.event_log: List[Dict] = []  # lifecycle events (Eventf analogue)
        # PVC ledger: claim -> {"node": ..., "bound": bool}; allocate assigns
        # the claim to a node (AssumePodVolumes analogue), bind finalizes it
        # (BindPodVolumes).  A claim already assigned to a DIFFERENT node
        # conflicts (volume topology), which the scheduler must surface as a
        # failed allocation.
        self.volumes: Dict[str, Dict] = {}
        # coordination.k8s.io Lease objects (leader election): "ns/name" ->
        # full Lease doc.  Writes CAS on metadata.resourceVersion the way the
        # real API server does — the seam ApiLeaseLock locks through.
        self.leases: Dict[str, Dict] = {}
        self.lease_rv = 0

    @staticmethod
    def key(kind: str, obj: Dict) -> str:
        from scheduler_tpu_torch.connector.wire import obj_name, pod_key

        if kind in ("pod", "podgroup"):
            return pod_key(obj)
        return obj_name(obj)  # both dialects (k8s metadata envelope or flat)

    def apply(self, kind: str, op: str, obj: Dict) -> None:
        with self.lock:
            self.apply_locked(kind, op, obj)

    def apply_locked(self, kind: str, op: str, obj: Dict) -> None:
        """``apply`` body for callers already holding the lock (read-modify-
        write sequences must be atomic under ThreadingHTTPServer)."""
        key = self.key(kind, obj)
        if kind == "pod" and not obj.get("uid"):
            # The system of record assigns identity (k8s UID analogue):
            # every later event for this pod carries the same uid.
            obj = dict(obj)
            obj["uid"] = f"wire-{key}"
        if op == "delete":
            obj = self.objects[kind].pop(key, obj)
        else:
            self.objects[kind][key] = obj
        self.seq += 1
        self.events.append({"seq": self.seq, "kind": kind, "op": op, "object": obj})
        # Bounded history: watchers older than the horizon must re-list
        # ("resourceVersion too old" — the k8s endpoints serve it as a
        # real 410 Gone Status).
        if len(self.events) > 10_000:
            self.compacted_through = self.events[4_999]["seq"]
            del self.events[:5_000]
        self.lock.notify_all()

    def take_failure(self, op: str) -> bool:
        with self.lock:
            left = self.fail.get(op, 0)
            if left > 0:
                self.fail[op] = left - 1
                return True
            return False


def make_handler(state: MockState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, payload, code=200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _stream(self, event: Dict) -> None:
            """One chunk of a watch stream: a newline-delimited JSON watch
            event, flushed immediately (HTTP/1.0 close-delimited body)."""
            self.wfile.write(json.dumps(event).encode() + b"\n")
            self.wfile.flush()

        def _k8s_list(self, kind: str, k8s_kind: str, q: Dict) -> None:
            raw_sel = q.get("fieldSelector", [None])[0]
            try:
                selector = _parse_field_selector(raw_sel)
            except ValueError as err:
                self._json({"error": str(err)}, 400)
                return
            if selector is not None and kind != "pod":
                # The real apiserver indexes spec.nodeName for pods only.
                self._json(
                    {"error": f"fieldSelector unsupported for {kind}"}, 400
                )
                return
            with state.lock:
                state.list_calls += 1
                items = list(state.objects[kind].values())
                if selector is not None:
                    op, value = selector
                    items = [
                        o for o in items
                        if (_pod_node_name(o) == value) == (op == "=")
                    ]
                # Deep-copy UNDER the lock (tear safety), serialize OUTSIDE
                # it: a full-cluster json.dumps inside the hold would stall
                # every watch/apply thread for the dump's duration.
                items = [json.loads(json.dumps(o)) for o in items]
                rv = str(state.seq)
            payload = {
                "apiVersion": "v1", "kind": f"{k8s_kind}List",
                "metadata": {"resourceVersion": rv},
                "items": items,
            }
            body = json.dumps(payload).encode()
            with state.lock:
                # Payload-size evidence for the split-relist tests: how many
                # bytes each LIST (and its selector) actually cost.
                state.list_log.append({
                    "kind": kind, "selector": raw_sel, "bytes": len(body),
                    "items": len(items),
                })
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _k8s_watch(self, kind: str, k8s_kind: str, q: Dict) -> None:
            """Chunked per-resource watch: stream this kind's events after
            the cursor until the window times out (close with a BOOKMARK
            when asked) — or end with an ERROR 410 when the history was
            compacted past the cursor mid-stream (or injected)."""
            since = int(q.get("resourceVersion", ["0"])[0])
            timeout = min(float(q.get("timeoutSeconds", ["10"])[0]), 30.0)
            bookmarks = q.get(
                "allowWatchBookmarks", ["false"]
            )[0].lower() in ("true", "1")
            # Sharded watch streams (the reflector's spec.nodeName
            # partitions): filter events by POST-state match, the real
            # apiserver's rule — a pod binding lands as an event on the
            # stream it NEWLY matches, so the assigned shard ingests the
            # bind and the shared cache upserts it out of the unassigned
            # partition.
            try:
                selector = _parse_field_selector(
                    q.get("fieldSelector", [None])[0]
                )
            except ValueError as err:
                self._json({"error": str(err)}, 400)
                return
            if selector is not None and kind != "pod":
                self._json(
                    {"error": f"fieldSelector unsupported for {kind}"}, 400
                )
                return

            def _shard_match(e: Dict) -> bool:
                if selector is None:
                    return True
                op, value = selector
                return (_pod_node_name(e["object"]) == value) == (op == "=")
            with state.lock:
                expired = since < state.compacted_through
            if expired:
                # Cursor behind the compaction horizon at watch START: the
                # real apiserver rejects the request itself.  (Responding
                # OUTSIDE the lock hold — a stalled reader must not wedge
                # every other handler thread behind the condition.)
                self._json(_gone_status(), 410)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            import bisect

            deadline = time.monotonic() + timeout
            last = since
            # The highest seq this stream has examined: the events after
            # ``last`` up to it are none of this stream's, so each wake
            # filters only what arrived since (the JAX copy re-filters every
            # event after ``last`` on each wake, which grows with the event
            # rate times the window for a stream whose kind is quiet).  The
            # events delivered are the same.
            scanned = last
            try:
                while True:
                    batch: List[Dict] = []
                    gone = False
                    bookmark_rv = None
                    with state.lock:
                        while True:
                            if state.take_failure(f"watch-gone:{kind}") or \
                                    last < state.compacted_through:
                                gone = True
                                break
                            # events are seq-sorted: bisect to the scan
                            # mark, then filter only the TAIL by kind.
                            idx = bisect.bisect_right(
                                state.events, scanned, key=lambda e: e["seq"]
                            )
                            batch = [
                                e for e in state.events[idx:]
                                if e["kind"] == kind and _shard_match(e)
                            ]
                            if state.events:
                                scanned = max(scanned, state.events[-1]["seq"])
                            if batch:
                                break
                            left = deadline - time.monotonic()
                            if left <= 0:
                                # Snapshot the bookmark cursor UNDER the
                                # lock that just confirmed nothing of this
                                # kind is pending: a concurrent event after
                                # release must not be skipped over.
                                bookmark_rv = state.seq
                                break
                            state.lock.wait(left)
                    for e in batch:
                        self._stream({
                            "type": _WATCH_TYPE_OF[e["op"]],
                            "object": _with_rv(e["object"], e["seq"]),
                        })
                        last = e["seq"]
                    if gone:
                        self._stream({"type": "ERROR", "object": _gone_status()})
                        return
                    if bookmark_rv is not None:
                        if bookmarks:
                            self._stream({"type": "BOOKMARK", "object": {
                                "kind": k8s_kind, "apiVersion": "v1",
                                "metadata": {
                                    "resourceVersion": str(max(bookmark_rv, last)),
                                },
                            }})
                        return
            except (BrokenPipeError, ConnectionResetError):
                return  # watcher hung up mid-stream

        def do_GET(self) -> None:
            url = urlparse(self.path)
            # ---- k8s apiserver mode: per-resource LIST + WATCH -------------
            collection = _K8S_COLLECTIONS.get(url.path)
            if collection is not None:
                kind, k8s_kind = collection
                q = parse_qs(url.query)
                if q.get("watch", ["0"])[0].lower() in ("1", "true"):
                    self._k8s_watch(kind, k8s_kind, q)
                else:
                    self._k8s_list(kind, k8s_kind, q)
                return
            obj_route = _k8s_object_route(url.path)
            if obj_route is not None:
                kind, key = obj_route
                with state.lock:
                    state.get_calls += 1
                    obj = state.objects[kind].get(key)
                if obj is None:
                    self._json({"error": "not found"}, 404)
                else:
                    self._json(obj)
                return
            if url.path == "/bind-log":
                # The wire surface stays the plain (pod, node) sequence the
                # journal-vs-k8s and event-vs-period parity tests compare
                # bitwise; the ``t`` receive stamps are in-process evidence
                # for the preempt-storm harness only.
                with state.lock:
                    binds = [{"pod": b["pod"], "node": b["node"]}
                             for b in state.bind_log]
                self._json({"binds": binds})
                return
            if url.path == "/state":
                with state.lock:
                    state.list_calls += 1
                    self._json({
                        "seq": state.seq,
                        "queues": list(state.objects["queue"].values()),
                        "nodes": list(state.objects["node"].values()),
                        "podGroups": list(state.objects["podgroup"].values()),
                        "pods": list(state.objects["pod"].values()),
                        "priorityClasses": list(state.objects["priorityclass"].values()),
                    })
                return
            if url.path == "/watch":
                import bisect

                q = parse_qs(url.query)
                since = int(q.get("since", ["0"])[0])
                timeout = float(q.get("timeout", ["10"])[0])
                deadline = time.monotonic() + timeout
                with state.lock:
                    while state.seq <= since:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        state.lock.wait(left)
                    if since < state.compacted_through:
                        # History pruned past the watcher's cursor: relist.
                        self._json({"relist": True})
                        return
                    # events are seq-sorted: bisect instead of a full rescan.
                    idx = bisect.bisect_right(
                        state.events, since, key=lambda e: e["seq"]
                    )
                    events = state.events[idx:]
                self._json({"events": events})
                return
            if url.path.startswith("/pods/"):
                _, _, ns, name = url.path.split("/", 3)
                with state.lock:
                    state.get_calls += 1
                    obj = state.objects["pod"].get(f"{ns}/{name}")
                if obj is None:
                    self._json({"error": "not found"}, 404)
                else:
                    self._json(obj)
                return
            if url.path.startswith("/objects/"):
                # Single-object GET (the reference syncTask's re-fetch shape):
                # /objects/<kind>/<key...> where key is ns/name or a bare name.
                _, _, kind, key = url.path.split("/", 3)
                with state.lock:
                    state.get_calls += 1
                    obj = state.objects.get(kind, {}).get(key)
                if obj is None:
                    self._json({"error": "not found"}, 404)
                else:
                    self._json(obj)
                return
            if url.path == "/stats":
                with state.lock:
                    self._json({
                        "bind_calls": state.bind_calls,
                        "evict_calls": state.evict_calls,
                        "get_calls": state.get_calls,
                        "list_calls": state.list_calls,
                        "status_updates": len(state.status_updates),
                        "k8s_calls": state.k8s_calls,
                        "legacy_calls": state.legacy_calls,
                        "seq": state.seq,
                    })
                return
            if url.path == "/volumes":
                with state.lock:
                    self._json(state.volumes)
                return
            if url.path == "/events-log":
                with state.lock:
                    self._json({"events": list(state.event_log)})
                return
            lease = self._lease_parts(url.path)
            if lease is not None and lease[1] is not None:
                with state.lock:
                    doc = state.leases.get(f"{lease[0]}/{lease[1]}")
                if doc is None:
                    self._json({"error": "not found"}, 404)
                else:
                    self._json(doc)
                return
            self._json({"error": "not found"}, 404)

        # -- shared mutation bodies (both dialects route here) ---------------

        def _do_bind(self, pairs, bulk: bool) -> None:
            failed = []
            for pair in pairs:
                with state.lock:
                    state.bind_calls += 1
                if state.take_failure("bind"):
                    failed.append(pair)
                    continue
                key = f"{pair.get('namespace', 'default')}/{pair['name']}"
                with state.lock:
                    pod = state.objects["pod"].get(key)
                if pod is None:
                    failed.append(pair)
                    continue
                pod = dict(pod)
                if isinstance(pod.get("metadata"), dict):
                    # Real k8s Pod shape: bind lands in spec/status.
                    pod["spec"] = dict(pod.get("spec", {}))
                    pod["spec"]["nodeName"] = pair["node"]
                    pod["status"] = dict(pod.get("status", {}))
                    pod["status"]["phase"] = "Running"
                else:
                    pod["nodeName"] = pair["node"]
                    pod["phase"] = "Running"
                # Echo on the watch stream: the scheduler's cache sees its
                # own bind come back as a pod update, like an informer.
                state.apply("pod", "update", pod)
                with state.lock:
                    state.bind_log.append({
                        "pod": key, "node": pair["node"],
                        "t": time.monotonic(),
                    })
            if not bulk:
                if failed:
                    self._json({"error": "bind failed"}, 500)
                else:
                    self._json({"ok": True})
            else:
                self._json({"failed": failed}, 200 if not failed else 409)

        def _do_evict(self, namespace: str, name: str) -> None:
            with state.lock:
                state.evict_calls += 1
            if state.take_failure("evict"):
                self._json({"error": "evict failed"}, 500)
                return
            key = f"{namespace}/{name}"
            with state.lock:
                pod = state.objects["pod"].get(key)
            if pod is not None:
                state.apply("pod", "delete", pod)
                with state.lock:
                    state.evict_log.append({"pod": key, "t": time.monotonic()})
            self._json({"ok": True})

        def _do_allocate_volumes(self, node: str, claims) -> None:
            if state.take_failure("allocate-volumes"):
                self._json({"error": "allocate-volumes failed"}, 500)
                return
            with state.lock:
                # Assumed-but-unbound claims may move (the k8s assume
                # cache reconciles stale assumptions); only a BOUND claim
                # on a different node is a hard topology conflict.
                for claim in claims:
                    entry = state.volumes.get(claim)
                    if entry is not None and entry["bound"] and entry["node"] != node:
                        self._json(
                            {"error": f"claim {claim} bound on {entry['node']}"},
                            409,
                        )
                        return
                for claim in claims:
                    entry = state.volumes.get(claim)
                    if entry is None or not entry["bound"]:
                        state.volumes[claim] = {"node": node, "bound": False}
            self._json({"ok": True})

        def _do_bind_volumes(self, claims) -> None:
            if state.take_failure("bind-volumes"):
                self._json({"error": "bind-volumes failed"}, 500)
                return
            with state.lock:
                for claim in claims:
                    entry = state.volumes.get(claim)
                    if entry is None:
                        self._json({"error": f"claim {claim} never allocated"}, 409)
                        return
                    entry["bound"] = True
            self._json({"ok": True})

        # k8s API path parsing: /api/v1/namespaces/{ns}/{resource}/{name}[/{sub}]
        @staticmethod
        def _k8s_parts(path: str):
            parts = path.strip("/").split("/")
            if len(parts) >= 5 and parts[0] == "api" and parts[2] == "namespaces":
                return parts[3], parts[4], parts[5] if len(parts) > 5 else None, (
                    parts[6] if len(parts) > 6 else None
                )
            return None

        @staticmethod
        def _lease_parts(path: str):
            # /apis/coordination.k8s.io/v1/namespaces/{ns}/leases[/{name}]
            parts = path.strip("/").split("/")
            if (
                len(parts) >= 6 and parts[0] == "apis"
                and parts[1] == "coordination.k8s.io"
                and parts[3] == "namespaces" and parts[5] == "leases"
            ):
                return parts[4], parts[6] if len(parts) > 6 else None
            return None

        def _do_lease_write(self, ns: str, name: str, body: Dict,
                            create: bool) -> None:
            """Create (POST, 409 when present) or CAS-update (PUT, 409 on a
            stale resourceVersion) one Lease — client-go resourcelock's
            server half."""
            key = f"{ns}/{name}"
            with state.lock:
                existing = state.leases.get(key)
                if create and existing is not None:
                    self._json({"error": "already exists"}, 409)
                    return
                if not create:
                    if existing is None:
                        self._json({"error": "not found"}, 404)
                        return
                    sent_rv = (body.get("metadata") or {}).get("resourceVersion")
                    live_rv = existing["metadata"].get("resourceVersion")
                    if sent_rv != live_rv:
                        self._json({"error": "resourceVersion conflict"}, 409)
                        return
                state.lease_rv += 1
                doc = {
                    "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {
                        "name": name, "namespace": ns,
                        "resourceVersion": str(state.lease_rv),
                    },
                    "spec": dict(body.get("spec") or {}),
                }
                state.leases[key] = doc
                self._json(doc, 201 if create else 200)

        def do_POST(self) -> None:
            url = urlparse(self.path)
            body = self._body()
            lease = self._lease_parts(url.path)
            if lease is not None:
                ns, name = lease
                if name is None:  # POST to the collection creates
                    name = (body.get("metadata") or {}).get("name", "")
                if not name:
                    self._json({"error": "lease needs a name"}, 422)
                    return
                self._do_lease_write(ns, name, body, create=True)
                return
            # --- k8s dialect: POST pods/{name}/binding, POST events ---------
            k8s = self._k8s_parts(url.path)
            if k8s is not None:
                with state.lock:
                    state.k8s_calls += 1
                ns, resource, name, sub = k8s
                if resource == "pods" and sub == "binding":
                    node = (body.get("target") or {}).get("name", "")
                    self._do_bind(
                        [{"namespace": ns, "name": name, "node": node}], bulk=False
                    )
                    return
                if resource == "events" and name is None:
                    with state.lock:
                        inv = body.get("involvedObject") or {}
                        state.event_log.append({
                            "namespace": inv.get("namespace", ns),
                            "name": inv.get("name", ""),
                            "type": body.get("type", "Normal"),
                            "reason": body.get("reason", ""),
                            "message": body.get("message", ""),
                        })
                        if len(state.event_log) > 50_000:
                            del state.event_log[:25_000]
                    self._json({"ok": True}, 201)
                    return
                self._json({"error": "not found"}, 404)
                return
            if url.path == "/objects":
                state.apply(body["kind"], body.get("op", "add"), body["object"])
                self._json({"ok": True}, 201)
                return
            if url.path == "/inject":
                op = body["op"]
                if op == "compact-history":
                    # etcd compaction analogue: the WHOLE journal is gone —
                    # every cursor behind the head now gets the relist
                    # signal (journal {"relist": true} / k8s 410 Gone), and
                    # active streams are woken to notice mid-window.
                    with state.lock:
                        state.compacted_through = state.seq
                        state.events.clear()
                        state.lock.notify_all()
                elif op == "silent-delete":
                    # Remove an object WITHOUT a journal event — the store
                    # mutation whose delete the compaction swallowed.  The
                    # version counter still advances (the mutation was
                    # real); only the echo is lost, so the object survives
                    # in every client cache as a ghost until a relist.
                    with state.lock:
                        state.objects[body["kind"]].pop(body["key"], None)
                        state.seq += 1
                else:
                    with state.lock:
                        state.fail[op] = int(body.get("times", 1))
                self._json({"ok": True})
                return
            if url.path in ("/bind", "/bind-bulk"):
                with state.lock:
                    state.legacy_calls += 1
                pairs = body["pairs"] if url.path == "/bind-bulk" else [body]
                self._do_bind(pairs, bulk=url.path == "/bind-bulk")
                return
            if url.path == "/evict":
                with state.lock:
                    state.legacy_calls += 1
                self._do_evict(body.get("namespace", "default"), body["name"])
                return
            if url.path == "/allocate-volumes":
                with state.lock:
                    state.legacy_calls += 1
                self._do_allocate_volumes(body["node"], body.get("claims", []))
                return
            if url.path == "/bind-volumes":
                with state.lock:
                    state.legacy_calls += 1
                self._do_bind_volumes(body.get("claims", []))
                return
            if url.path == "/podgroup-status":
                with state.lock:
                    state.legacy_calls += 1
                # Status updates land on the stored object and echo on the
                # watch stream — the scheduler's own phase write (e.g.
                # Pending -> Inqueue at enqueue) must survive a relist.  The
                # read-copy-apply runs under ONE lock hold: a concurrent
                # object update must not be overwritten by a stale snapshot.
                with state.lock:
                    state.status_updates.append(body)
                    key = f"{body.get('namespace', 'default')}/{body['name']}"
                    pg = state.objects["podgroup"].get(key)
                    if pg is not None and body.get("phase"):
                        pg = dict(pg)
                        # Store the FULL pushed status (a real apiserver
                        # persists the whole subresource): the echo must
                        # round-trip losslessly or the scheduler re-pushes
                        # an apparently-changed status every session close.
                        for fld in ("phase", "running", "succeeded",
                                    "failed", "conditions"):
                            if body.get(fld) is not None:
                                pg[fld] = body[fld]
                        state.apply_locked("podgroup", "update", pg)
                self._json({"ok": True})
                return
            if url.path == "/pod-condition":
                with state.lock:
                    state.legacy_calls += 1
                with state.lock:
                    state.status_updates.append(body)
                self._json({"ok": True})
                return
            if url.path == "/events":
                with state.lock:
                    state.legacy_calls += 1
                # Lifecycle event sink (Recorder.Eventf analogue); bounded.
                with state.lock:
                    state.event_log.extend(body.get("events", []))
                    if len(state.event_log) > 50_000:
                        del state.event_log[:25_000]
                self._json({"ok": True})
                return
            self._json({"error": "not found"}, 404)

        def do_PUT(self) -> None:
            # Lease renew/takeover: CAS'd on resourceVersion.
            url = urlparse(self.path)
            lease = self._lease_parts(url.path)
            if lease is not None and lease[1] is not None:
                self._do_lease_write(
                    lease[0], lease[1], self._body(), create=False
                )
                return
            self._json({"error": "not found"}, 404)

        def do_DELETE(self) -> None:
            # k8s dialect: eviction is a pod DELETE (defaultEvictor,
            # cache.go:125-144).
            url = urlparse(self.path)
            lease = self._lease_parts(url.path)
            if lease is not None and lease[1] is not None:
                with state.lock:
                    gone = state.leases.pop(f"{lease[0]}/{lease[1]}", None)
                self._json({"ok": True} if gone else {"error": "not found"},
                           200 if gone else 404)
                return
            k8s = self._k8s_parts(url.path)
            if k8s is not None:
                with state.lock:
                    state.k8s_calls += 1
                ns, resource, name, sub = k8s
                if resource == "pods" and name and sub is None:
                    self._do_evict(ns, name)
                    return
            self._json({"error": "not found"}, 404)

        def do_PATCH(self) -> None:
            """k8s dialect status writes: pod status subresource, PodGroup
            CRD status subresource, and PVC annotation patches (the volume
            binder's assume/bind shapes)."""
            url = urlparse(self.path)
            body = self._body()
            k8s = self._k8s_parts(url.path)
            if k8s is not None:
                with state.lock:
                    state.k8s_calls += 1
                ns, resource, name, sub = k8s
                if resource == "pods" and sub == "status":
                    conds = (body.get("status") or {}).get("conditions", [])
                    with state.lock:
                        for c in conds:
                            state.status_updates.append({
                                "namespace": ns, "name": name,
                                "type": c.get("type", ""),
                                "status": c.get("status", ""),
                                "reason": c.get("reason", ""),
                                "message": c.get("message", ""),
                            })
                    self._json({"ok": True})
                    return
                if resource == "persistentvolumeclaims" and name:
                    ann = (body.get("metadata") or {}).get("annotations", {})
                    node = ann.get("volume.kubernetes.io/selected-node")
                    if node:
                        self._do_allocate_volumes(node, [name])
                        return
                    if ann.get("pv.kubernetes.io/bind-completed") == "yes":
                        self._do_bind_volumes([name])
                        return
                    self._json({"error": "unknown PVC patch"}, 400)
                    return
                self._json({"error": "not found"}, 404)
                return
            # CRD status: /apis/scheduling.incubator.k8s.io/v1alpha1/
            #             namespaces/{ns}/podgroups/{name}/status
            parts = url.path.strip("/").split("/")
            if (
                len(parts) == 8
                and parts[0] == "apis"
                and parts[1] == "scheduling.incubator.k8s.io"
                and parts[3] == "namespaces"
                and parts[5] == "podgroups"
                and parts[7] == "status"
            ):
                ns, name = parts[4], parts[6]
                status = body.get("status") or {}
                with state.lock:
                    state.k8s_calls += 1
                    state.status_updates.append({
                        "namespace": ns, "name": name,
                        "phase": status.get("phase", ""),
                        "conditions": status.get("conditions", []),
                    })
                    key = f"{ns}/{name}"
                    pg = state.objects["podgroup"].get(key)
                    if pg is not None and status.get("phase"):
                        pg = dict(pg)
                        # Persist the whole status subresource (see the
                        # /podgroup-status handler note): lossy storage
                        # makes the echo perpetually "changed".
                        if isinstance(pg.get("metadata"), dict):
                            pg["status"] = dict(pg.get("status", {}))
                            pg["status"].update(status)
                        else:
                            pg["phase"] = status["phase"]
                            for fld in ("running", "succeeded", "failed",
                                        "conditions"):
                                if status.get(fld) is not None:
                                    pg[fld] = status[fld]
                        state.apply_locked("podgroup", "update", pg)
                self._json({"ok": True})
                return
            self._json({"error": "not found"}, 404)

    return Handler


class _Server(ThreadingHTTPServer):
    # The churn rig (docs/CHURN.md) floods the server with short-lived
    # connections (urllib opens one per RPC); the http.server default
    # listen backlog of 5 drops SYNs under that load and clients stall in
    # connect.  A real apiserver listens far deeper.
    request_queue_size = 128
    daemon_threads = True


def serve(port: int, state: Optional[MockState] = None):
    """A mock API server on ``port`` (0: a free one) over ``state`` (a
    fresh store by default); the caller runs ``serve_forever``."""
    state = state if state is not None else MockState()
    server = _Server(("127.0.0.1", port), make_handler(state))
    return server, state


def main() -> None:
    parser = argparse.ArgumentParser(prog="mock-apiserver")
    parser.add_argument("--port", type=int, default=18200)
    ns = parser.parse_args()
    server, _state = serve(ns.port)
    # Report the BOUND port, not the requested one: --port 0 lets the OS
    # assign a free port and the spawning test reads it back from this line.
    print(f"mock apiserver on :{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
