"""The external wire: a SchedulerCache fed by a remote API server.

The reference's cache is an informer mirror of the Kubernetes API server with
RPC side effects (``cache/cache.go:256-336`` watch streams in, ``:447-487``
binds/evictions out).  This module is that seam over HTTP/JSON:

* **list+watch in**: one LIST (``GET /state``) seeds the cache, then a watch
  thread long-polls ``GET /watch?since=seq`` and applies add/update/delete
  events for pods / nodes / podgroups / queues / priority classes through the
  cache's event-handler methods — the informer fan-in (event_handlers.go).
  This is the *journal* wire; ``SCHEDULER_TORCH_WIRE=k8s`` swaps ingestion for
  the Kubernetes-conformant per-resource LIST+WATCH reflectors in
  ``connector/reflector.py`` (same ``_apply`` seam, real apiserver protocol
  — see ``docs/INGEST.md`` for the protocol table).
* **RPCs out**: Binder / Evictor / StatusUpdater implementations POST to the
  server.  A failed bind raises; the cache's existing resync path reverts the
  local Binding state so the next cycle retries (errTasks semantics,
  cache.go:559-581) — and the server's eventual watch echo reconciles any
  remaining drift, exactly the reference's crash-tolerant reconcile model.
  A bind POST that gets no answer (a timeout, a dropped connection) may
  still be applied by the server, so it is sent again, unchanged, until the
  server answers (``_post_bind``): the cache reverts a bind only on the
  server's word, or once it is stopping (``Binder.close``).

Transport is stdlib ``urllib`` — the wire format, not the client library, is
the contract.  Outbound RPCs share one client-side QPS+burst token bucket
(``TokenBucket``; ``SCHEDULER_TORCH_QPS`` / ``SCHEDULER_TORCH_BURST``) — the
reference kube-client's flowcontrol limiter.

This is the port's own copy of the JAX package's connector
(``scheduler_tpu/connector/client.py``), without its lockset-sanitizer hooks.
It departs from it in one place: the JAX connector gives up a bind whose
POST got no answer at once, and its cache reverts it, so a bind the server
applies later lands beside the pod that the next cycle put in its room.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from scheduler_tpu_torch.api.vocab import ResourceVocabulary
from scheduler_tpu_torch.cache.cache import SchedulerCache
from scheduler_tpu_torch.cache.interface import (
    Binder,
    BulkBindError,
    Evictor,
    StatusUpdater,
    VolumeBinder,
)
from scheduler_tpu_torch.connector.wire import (
    CRD_PREFIX,
    parse_node,
    parse_pod,
    parse_pod_group,
    parse_queue,
    obj_name,
    pod_key,
    pod_uid,
)
from scheduler_tpu_torch.utils import trace

logger = logging.getLogger("scheduler_tpu_torch.connector")


class TokenBucket:
    """Client-side QPS + burst rate limiter for the outbound RPCs — the
    reference's kube-client flowcontrol limiter (its ``--kube-api-qps`` /
    ``--kube-api-burst`` flags).  A concurrency bound is not a rate bound:
    N io-workers retiring fast RPCs exceed any intended QPS.

    Semantics match client-go's ``tokenBucketRateLimiter``: a bucket of
    ``burst`` tokens refills continuously at ``qps`` tokens/second;
    ``acquire`` takes one token, going into DEBT when the bucket is empty
    and sleeping until its token's refill time — so concurrent callers are
    paced at exactly ``qps`` once the burst is spent, in arrival order of
    their bucket reservations.  The clock and sleep are injectable so tests
    drive time deterministically; the lock is held only for the reservation
    arithmetic, never across a sleep."""

    def __init__(
        self,
        qps: float,
        burst: int,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        if qps <= 0:
            raise ValueError(f"qps must be positive, got {qps}")
        self.qps = float(qps)
        self.burst = float(max(1, burst))
        self._clock = clock
        self._sleep = sleep
        # One bucket is shared by every io-worker via connect_cache.
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def acquire(self) -> float:
        """Reserve one request slot, blocking until it is due.  Returns the
        seconds slept (0.0 within the burst) — surfaced for tests and for
        callers that want to log throttling."""
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.qps
            )
            self._last = now
            self._tokens -= 1.0
            wait = 0.0 if self._tokens >= 0.0 else -self._tokens / self.qps
        if wait > 0.0:
            self._sleep(wait)
        return wait


class Backoff:
    """Jittered exponential backoff for the connector's retry loops — the
    client-go ``wait.Backoff`` the reference's reflectors retry through.

    A dead or rebooting API server used to be hammered in a tight 1s
    warn-and-retry loop by every watcher at once; with N schedulers (leader
    + standbys, each with per-resource reflectors) that is a synchronized
    reconnect stampede exactly when the server is least able to absorb it.
    ``next()`` returns the current delay with multiplicative jitter
    (``delay * (1 + jitter*rand)``, so delays from different processes
    decorrelate) and doubles the base up to ``cap``; ``reset()`` on any
    success returns to the floor.  The RNG is injectable for deterministic
    tests."""

    def __init__(
        self,
        base: float = 0.5,
        cap: float = 30.0,
        factor: float = 2.0,
        jitter: float = 0.5,
        rng: Callable[[], float] = random.random,
    ) -> None:
        if base <= 0 or factor < 1.0 or cap < base:
            raise ValueError(f"malformed backoff ({base=}, {factor=}, {cap=})")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = rng
        self._delay = base

    def next(self) -> float:
        """The delay to sleep NOW; advances the schedule."""
        delay = self._delay * (1.0 + self.jitter * self._rng())
        self._delay = min(self.cap, self._delay * self.factor)
        return delay

    def reset(self) -> None:
        self._delay = self.base


def rate_limiter_from_env() -> Optional[TokenBucket]:
    """The connector's limiter as configured by ``SCHEDULER_TORCH_QPS`` /
    ``SCHEDULER_TORCH_BURST``.  QPS unset or <= 0 disables limiting (today's
    behavior); BURST defaults to ceil(qps) — one second of headroom, like
    the reference's qps<=burst convention."""
    from scheduler_tpu_torch.utils.envflags import env_float, env_int

    qps = env_float("SCHEDULER_TORCH_QPS", 0.0, minimum=0.0)
    if qps <= 0.0:
        return None
    burst = env_int("SCHEDULER_TORCH_BURST", int(-(-qps // 1)), minimum=1)
    return TokenBucket(qps, burst)


def _request(
    base: str, path: str, payload: Optional[dict], method: str,
    timeout: float = 10.0, limiter: Optional[TokenBucket] = None,
) -> dict:
    if limiter is not None:
        limiter.acquire()
    req = urllib.request.Request(
        base + path,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method=method,
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _post(base: str, path: str, payload: dict, timeout: float = 10.0,
          limiter: Optional[TokenBucket] = None) -> dict:
    return _request(base, path, payload, "POST", timeout, limiter)


def _patch(base: str, path: str, payload: dict, timeout: float = 10.0,
           limiter: Optional[TokenBucket] = None) -> dict:
    return _request(base, path, payload, "PATCH", timeout, limiter)


def _delete(base: str, path: str, timeout: float = 10.0,
            limiter: Optional[TokenBucket] = None) -> dict:
    return _request(base, path, None, "DELETE", timeout, limiter)


# Longest pause between two sends of one unanswered bind POST, seconds.
BIND_PAUSE_MAX = 2.0


def _unanswered(err: Exception) -> bool:
    """True for a failure that leaves unknown whether the server applied the
    request: no HTTP status came back (a timeout, a refused or dropped
    connection, a cut response)."""
    if isinstance(err, urllib.error.HTTPError):
        return False
    return isinstance(err, (OSError, http.client.HTTPException))


def _post_bind(base: str, path: str, payload: dict, closed: threading.Event,
               limiter: Optional[TokenBucket] = None) -> dict:
    """POST a bind, sent again unchanged while the server gives no answer,
    with a pause that doubles up to ``BIND_PAUSE_MAX``, until the server
    answers or ``closed`` is set (the cache is stopping: then the failure
    raises).  A bind names its pods and their nodes, so a second send of one
    the server has applied binds the same pods to the same nodes: harmless,
    where giving it up would let the cache revert it and free room that the
    server fills once the first send lands."""
    pause = 0.1
    while True:
        try:
            return _post(base, path, payload, limiter=limiter)
        except Exception as err:
            if not _unanswered(err) or closed.is_set():
                raise
            logger.warning("bind POST %s got no answer (%r); sending it again", path, err)
            if closed.wait(pause):
                raise
            pause = min(2.0 * pause, BIND_PAUSE_MAX)


def _cond_field(condition, name: str) -> str:
    """Condition accessor shared by both status-updater dialects: the cache
    passes conditions as plain dicts (record_job_status_event); attribute-
    style objects are accepted too."""
    if isinstance(condition, dict):
        return str(condition.get(name, ""))
    return str(getattr(condition, name, ""))


def _get_sized(base: str, path: str, timeout: float = 30.0) -> tuple:
    """``_get`` that also returns the payload size in bytes — LIST/relist
    cost evidence for the reflectors (docs/INGEST.md "Field-selector
    relists")."""
    with urllib.request.urlopen(base + path, timeout=timeout) as resp:
        body = resp.read() or b"{}"
    return json.loads(body), len(body)


def _get(base: str, path: str, timeout: float = 30.0) -> dict:
    return _get_sized(base, path, timeout)[0]


class HttpBinder(Binder):
    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter
        self.closed = threading.Event()

    def close(self) -> None:
        self.closed.set()

    def bind(self, pod, hostname: str) -> None:
        with trace.span("rpc:bind"):
            _post_bind(self.base, "/bind", {
                "namespace": pod.namespace, "name": pod.name, "node": hostname,
            }, self.closed, limiter=self.limiter)

    def bind_bulk(self, pairs: list) -> None:
        payload = {"pairs": [
            {"namespace": pod.namespace, "name": pod.name, "node": hostname}
            for pod, hostname in pairs
        ]}
        try:
            with trace.span("rpc:bind_bulk", pairs=len(pairs)):
                _post_bind(self.base, "/bind-bulk", payload, self.closed,
                           limiter=self.limiter)
        except urllib.error.HTTPError as err:
            if err.code != 409:
                raise  # transport/unknown failure: caller assumes nothing applied
            failed_keys = {
                (f.get("namespace", "default"), f["name"])
                for f in json.loads(err.read() or b"{}").get("failed", [])
            }
            raise BulkBindError([
                (pod, hostname)
                for pod, hostname in pairs
                if (pod.namespace, pod.name) in failed_keys
            ]) from err


class HttpEvictor(Evictor):
    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter

    def evict(self, pod) -> None:
        with trace.span("rpc:evict"):
            _post(self.base, "/evict",
                  {"namespace": pod.namespace, "name": pod.name},
                  limiter=self.limiter)


class HttpVolumeBinder(VolumeBinder):
    """Volume claim RPCs (reference cache.go:189-209: defaultVolumeBinder wraps
    the k8s volumebinder's AssumePodVolumes/BindPodVolumes API calls).

    Only pods that actually mount claims pay an RPC; a claim-less pod is a
    local no-op, which keeps claim-free workloads on the zero-RPC fast path.
    A failed allocate raises (the task's placement aborts and resyncs); a
    failed bind raises into the bind path's existing resync machinery.
    """

    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter

    def allocate_volumes(self, task, hostname: str) -> None:
        claims = task.pod.volume_claims
        if not claims:
            return
        _post(self.base, "/allocate-volumes", {
            "namespace": task.pod.namespace, "name": task.pod.name,
            "node": hostname, "claims": list(claims),
        }, limiter=self.limiter)

    def bind_volumes(self, task) -> None:
        claims = task.pod.volume_claims
        if not claims:
            return
        _post(self.base, "/bind-volumes", {
            "namespace": task.pod.namespace, "name": task.pod.name,
            "claims": list(claims),
        }, limiter=self.limiter)


class HttpStatusUpdater(StatusUpdater):
    # Lifecycle events (Scheduled/Evict/FailedScheduling) cross the wire —
    # the reference's Recorder.Eventf against the API server.
    RECORDS_EVENTS = True

    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter

    def record_events(self, events: list) -> None:
        try:
            _post(self.base, "/events", {"events": events},
                  limiter=self.limiter)
        except Exception:
            logger.warning("event batch dropped (%d events)", len(events))

    def update_pod_condition(self, pod, condition) -> None:
        _post(self.base, "/pod-condition", {
            "namespace": pod.namespace, "name": pod.name,
            "type": _cond_field(condition, "type"),
            "status": _cond_field(condition, "status"),
            "reason": _cond_field(condition, "reason"),
            "message": _cond_field(condition, "message"),
        }, limiter=self.limiter)

    def update_pod_group(self, job) -> None:
        pg = job.pod_group
        if pg is None or getattr(pg, "shadow", False):
            # Shadow PodGroups are synthesized locally for bare pods
            # (cache/util.go:30-63); the system of record has no such
            # object — pushing its status would 404 every cycle.
            return
        _post(self.base, "/podgroup-status", {
            "namespace": pg.namespace, "name": pg.name,
            # FULL status fidelity: the push echoes back over the watch
            # stream and replaces the cached status — a lossy body would
            # diff "changed" at every session close and re-push forever
            # (the event loop docs/CHURN.md describes).
            "phase": str(pg.status.phase),
            "running": pg.status.running,
            "succeeded": pg.status.succeeded,
            "failed": pg.status.failed,
            "conditions": _encode_pg_conditions(pg),
        }, limiter=self.limiter)


def _encode_pg_conditions(pg) -> list:
    """Full-fidelity condition encoding, shared by both status-updater
    dialects (the parse twin is ``wire._parse_pg_condition``)."""
    return [
        {
            "type": c.type, "status": c.status, "reason": c.reason,
            "message": c.message, "transitionID": c.transition_id,
            "lastTransitionTime": c.last_transition_time,
        }
        for c in pg.status.conditions
    ]


class K8sBinder(Binder):
    """Binds as the Kubernetes wire does it: POST the ``pods/binding``
    subresource with a v1 Binding body (reference ``defaultBinder.Bind``,
    cache/cache.go:110-123)."""

    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter
        self.closed = threading.Event()

    def close(self) -> None:
        self.closed.set()

    def bind(self, pod, hostname: str) -> None:
        with trace.span("rpc:bind"):
            _post_bind(
                self.base,
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/binding",
                {
                    "apiVersion": "v1",
                    "kind": "Binding",
                    "metadata": {"name": pod.name, "namespace": pod.namespace},
                    "target": {"apiVersion": "v1", "kind": "Node", "name": hostname},
                },
                self.closed,
                limiter=self.limiter,
            )

    def bind_bulk(self, pairs: list) -> None:
        # The k8s API has no bulk bind; the reference fires one goroutine per
        # bind.  Per-pod POSTs here, folding failures into the BulkBindError
        # contract (listed pairs failed, everything else applied).
        failed = []
        for pod, hostname in pairs:
            try:
                self.bind(pod, hostname)
            except Exception:
                logger.warning("k8s bind failed for %s/%s", pod.namespace, pod.name)
                failed.append((pod, hostname))
        if failed:
            raise BulkBindError(failed)


class K8sEvictor(Evictor):
    """Evicts by DELETEing the pod (reference ``defaultEvictor.Evict``,
    cache/cache.go:125-144)."""

    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter

    def evict(self, pod) -> None:
        with trace.span("rpc:evict"):
            _delete(self.base,
                    f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}",
                    limiter=self.limiter)


class K8sVolumeBinder(VolumeBinder):
    """Volume RPCs in PVC shapes: allocate = the ``selected-node`` annotation
    the k8s volume binder's AssumePodVolumes writes on delayed-binding
    claims; bind = the ``bind-completed`` annotation BindPodVolumes
    finalizes (reference cache.go:189-209).

    Allocation is per-claim and NOT atomic across a pod's claims — exactly
    the k8s assume-cache model: a conflict mid-pod (some claim already BOUND
    elsewhere) aborts the task's placement with earlier claims left assumed,
    and that residue is benign by design because assumed-but-unbound claims
    are movable (the server re-assigns them on the next allocation; only
    ``bind-completed`` pins a claim)."""

    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter

    def _patch_claim(self, namespace: str, claim: str, annotations: dict) -> None:
        _patch(
            self.base,
            f"/api/v1/namespaces/{namespace}/persistentvolumeclaims/{claim}",
            {"metadata": {"annotations": annotations}},
            limiter=self.limiter,
        )

    def allocate_volumes(self, task, hostname: str) -> None:
        for claim in task.pod.volume_claims:
            self._patch_claim(
                task.pod.namespace, claim,
                {"volume.kubernetes.io/selected-node": hostname},
            )

    def bind_volumes(self, task) -> None:
        for claim in task.pod.volume_claims:
            self._patch_claim(
                task.pod.namespace, claim,
                {"pv.kubernetes.io/bind-completed": "yes"},
            )


class K8sStatusUpdater(StatusUpdater):
    """Status writes in Kubernetes shapes: pod conditions PATCH the pod's
    ``status`` subresource (reference ``defaultStatusUpdater.UpdatePodCondition``
    -> UpdatePodStatus, cache.go:146-187), PodGroup status PATCHes the CRD's
    status subresource, and lifecycle events POST as v1 Events (Recorder)."""

    RECORDS_EVENTS = True
    # Bounded like client-go's event broadcaster queue; overflow drops the
    # OLDEST events (lifecycle events are advisory, never load-bearing).
    _QUEUE_CAP = 10_000

    def __init__(self, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.base = base
        self.limiter = limiter
        # The k8s API takes ONE Event per POST, and the reference's Recorder
        # is asynchronous (client-go's broadcaster queues events and a
        # background goroutine sends them) — a per-event synchronous POST
        # from the cycle thread would charge N wire round trips per cycle to
        # a FailedScheduling backlog of N pods.  Same model here: enqueue,
        # drain on a daemon thread.
        self._events: list = []
        self._ev_lock = threading.Condition()
        self._ev_stop = False
        self._ev_thread = threading.Thread(
            target=self._drain_events, name="k8s-event-recorder", daemon=True
        )
        self._ev_thread.start()

    def close(self) -> None:
        """Post what is queued, then end the sender thread."""
        with self._ev_lock:
            self._ev_stop = True
            self._ev_lock.notify()
        self._ev_thread.join(timeout=10)

    def record_events(self, events: list) -> None:
        with self._ev_lock:
            self._events.extend(events)
            if len(self._events) > self._QUEUE_CAP:
                del self._events[: len(self._events) - self._QUEUE_CAP]
            self._ev_lock.notify()

    def _drain_events(self) -> None:
        while True:
            with self._ev_lock:
                while not self._events and not self._ev_stop:
                    self._ev_lock.wait()
                if self._ev_stop and not self._events:
                    return
                batch, self._events = self._events, []
            for ev in batch:
                try:
                    self._post_event(ev)
                except Exception:
                    logger.warning("k8s event dropped for %s", ev.get("name"))

    def _post_event(self, ev: dict) -> None:
        ns = ev.get("namespace", "default")
        _post(self.base, f"/api/v1/namespaces/{ns}/events", {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"namespace": ns,
                         "generateName": f"{ev.get('name', '')}."},
            "involvedObject": {
                "kind": "Pod", "namespace": ns, "name": ev.get("name", ""),
            },
            "type": ev.get("type", "Normal"),
            "reason": ev.get("reason", ""),
            "message": ev.get("message", ""),
        }, limiter=self.limiter)

    def update_pod_condition(self, pod, condition) -> None:
        _patch(
            self.base,
            f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}/status",
            {"status": {"conditions": [{
                "type": _cond_field(condition, "type") or "PodScheduled",
                "status": _cond_field(condition, "status"),
                "reason": _cond_field(condition, "reason"),
                "message": _cond_field(condition, "message"),
            }]}},
            limiter=self.limiter,
        )

    def update_pod_group(self, job) -> None:
        pg = job.pod_group
        if pg is None or getattr(pg, "shadow", False):
            # Shadow PodGroups never exist on the API server (see the
            # journal updater above): a status PATCH would 404 and abort
            # the session close for every bare pod in the cluster.
            return
        _patch(
            self.base,
            f"{CRD_PREFIX}/namespaces/{pg.namespace}/podgroups/{pg.name}/status",
            {
                "apiVersion": "scheduling.incubator.k8s.io/v1alpha1",
                "kind": "PodGroup",
                "metadata": {"name": pg.name, "namespace": pg.namespace},
                # Full status, like the journal updater: the PATCH echoes
                # back through the reflector and must round-trip losslessly
                # or every session close re-pushes it (docs/CHURN.md).
                "status": {
                    "phase": str(pg.status.phase),
                    "running": pg.status.running,
                    "succeeded": pg.status.succeeded,
                    "failed": pg.status.failed,
                    "conditions": _encode_pg_conditions(pg),
                },
            },
            limiter=self.limiter,
        )


class ConnectorBase:
    """The protocol-independent ingestion half shared by BOTH inbound wire
    protocols: the parse-and-apply seam (``_dispatch``), per-event failure
    recovery (single-object resync, then kind-level dirty), and the
    ``sync_pod`` client slot the cache's bind-failure paths call.

    Two subclasses speak the actual wires (docs/INGEST.md):

    * ``ApiConnector`` (here) — the bespoke journal protocol: one global
      LIST (``GET /state``) + one sequence-cursor long-poll
      (``GET /watch?since=seq``).
    * ``reflector.K8sApiConnector`` — Kubernetes-conformant per-resource
      LIST + WATCH streams with resourceVersion cursors and ``410 Gone``
      relist recovery, the way client-go informs the reference's cache.

    Everything the cache sees is identical between them — same ``_apply``
    calls, same parsers, same resync semantics — which is what makes the
    journal-vs-k8s bind-parity test meaningful."""

    def __init__(self, cache: SchedulerCache, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        self.cache = cache
        self.base = base
        # LISTs and relists pay the shared outbound QPS budget (a relist
        # storm is exactly the full-inventory burst the reference's
        # flowcontrol limiter exists to pace); the watch long-polls stay
        # deliberately OUTSIDE it — see connect_cache's docstring.
        self.limiter = limiter
        self._stop = threading.Event()
        self.synced = threading.Event()
        # Set when an event failed to apply: the cache may be divergent for
        # that object, so the loop re-LISTs (full store replace) instead of
        # silently drifting until an unrelated relist (the reference's
        # syncTask re-fetch, event_handlers.go:96-114).
        self._dirty = False
        # Cycle trigger (utils/trigger.py, docs/CHURN.md): when the scheduler
        # runs SCHEDULER_TORCH_TRIGGER=event, every event applied through the
        # shared ``_apply`` seam notifies it — both inbound protocols route
        # here, so event pacing is wire-agnostic.  ``events_applied`` counts
        # regardless, as ingest evidence.
        self.trigger = None
        self.events_applied = 0
        self._events_lock = threading.Lock()  # reflectors apply concurrently

    def set_trigger(self, trigger) -> None:
        """Attach the scheduler loop's CycleTrigger to this connector's
        ``_apply`` seam (called by Scheduler._run_event_loop)."""
        self.trigger = trigger

    # -- event application ---------------------------------------------------

    def _mark_dirty(self, kind: str) -> None:
        """Kind ``kind`` may have diverged beyond single-object repair; the
        owning loop must re-LIST.  The journal protocol relists everything
        (one global inventory); the reflector overrides this to relist only
        the affected resource."""
        self._dirty = True

    def _apply(self, kind: str, op: str, obj: dict) -> None:
        try:
            self._dispatch(kind, op, obj)
        except Exception:
            logger.exception(
                "failed to apply %s %s event; single-object resync", op, kind
            )
            # The reference syncTask re-fetches ONE object to rebuild truth
            # (event_handlers.go:96-114); a full relist is reserved for
            # watch-horizon loss.  Only when the re-fetch itself fails does
            # the store fall back to a replace.
            if not self._resync_object(kind, obj):
                self._mark_dirty(kind)
        # Successful or repaired, the cluster state (probably) moved: one
        # trigger notify per applied event — the scheduler's debounce window
        # does the batching, not this hot path.
        with self._events_lock:
            self.events_applied += 1
        if self.trigger is not None:
            self.trigger.notify()

    def _object_key(self, kind: str, obj: dict) -> str:
        if kind in ("pod", "podgroup"):
            return pod_key(obj)
        return obj_name(obj)

    def get_object(self, kind: str, key: str) -> Optional[dict]:
        """GET one object from the system of record; None == 404 (deleted).
        Transport errors raise.  Protocol-specific: the journal fetches
        ``/objects/{kind}/{key}``, the k8s wire the typed resource path."""
        raise NotImplementedError

    def _resync_object(self, kind: str, obj: dict) -> bool:
        """Re-fetch one object and re-apply it as the current truth (delete
        when the server no longer has it).  True == handled."""
        try:
            key = self._object_key(kind, obj)
            fresh = self.get_object(kind, key)
            if fresh is None:
                self._dispatch(kind, "delete", obj)
            else:
                self._dispatch(kind, "update", fresh)
            return True
        except Exception:
            logger.exception("single-object resync failed for %s", kind)
            return False

    def _dispatch(self, kind: str, op: str, obj: dict) -> None:
        """The ONE parse-and-apply switch (events, seeding, and single-object
        resync all route here; failure recovery lives in the callers)."""
        cache = self.cache
        if kind == "pod":
            pod = parse_pod(obj, cache.scheduler_name)
            if op == "add":
                cache.add_pod(pod)
            elif op == "update":
                cache.update_pod(pod)
            else:
                cache.delete_pod(pod)
        elif kind == "node":
            node = parse_node(obj)
            if op == "add":
                cache.add_node(node)
            elif op == "update":
                cache.update_node(node)
            else:
                cache.delete_node(node)
        elif kind == "podgroup":
            pg = parse_pod_group(obj)
            if op == "delete":
                cache.delete_pod_group(pg)
            elif op == "update":
                cache.update_pod_group(pg)
            else:
                cache.add_pod_group(pg)
        elif kind == "queue":
            q = parse_queue(obj)
            if op == "delete":
                cache.delete_queue(q)
            else:
                cache.add_queue(q)
        elif kind == "priorityclass":
            if op == "delete":
                cache.delete_priority_class(obj_name(obj))
            else:
                cache.add_priority_class(obj_name(obj), int(obj.get("value", 0)))

    def sync_pod(self, namespace: str, name: str) -> bool:
        """The syncTask seam for the cache's failure paths: re-fetch one pod
        and rebuild its task from the server's truth (or delete it when the
        server no longer has it).  True == cache now reflects the server."""
        try:
            fresh = self.get_object("pod", f"{namespace}/{name}")
        except Exception:
            logger.exception("sync_pod GET failed for %s/%s", namespace, name)
            return False
        try:
            if fresh is None:
                # Server no longer has it: the local pod is a ghost.
                existing = self._find_pod(namespace, name)
                if existing is not None:
                    self.cache.delete_pod(existing)
            else:
                self.cache.update_pod(parse_pod(fresh, self.cache.scheduler_name))
            return True
        except Exception:
            logger.exception("sync_pod apply failed for %s/%s", namespace, name)
            return False

    def _find_pod(self, namespace: str, name: str):
        with self.cache.mutex:
            for job in self.cache.jobs.values():
                st = job.store
                for uid, row in st.row_of.items():
                    core = st.cores[row]
                    if core.namespace == namespace and core.name == name:
                        return core.pod
        return None

    def start(self) -> None:
        raise NotImplementedError

    def wait_for_cache_sync(self, timeout: float = 60.0) -> bool:
        """Block until the initial LIST has seeded the cache
        (cache.WaitForCacheSync, cache.go:364-384)."""
        return self.synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        self._close_status_updater()

    def _close_status_updater(self) -> None:
        """End the k8s dialect's event sender thread (the port's connector
        leaves no thread behind once stopped)."""
        close = getattr(self.cache.status_updater, "close", None)
        if close is not None:
            close()


class ApiConnector(ConnectorBase):
    """Journal-protocol ingestion loop: one global LIST (``GET /state``) +
    one sequence-cursor long-poll (``GET /watch?since=seq``) feeding the
    SchedulerCache.  The bespoke predecessor of the k8s reflector wire
    (``SCHEDULER_TORCH_WIRE=journal``, docs/INGEST.md)."""

    def __init__(self, cache: SchedulerCache, base: str,
                 limiter: Optional[TokenBucket] = None) -> None:
        super().__init__(cache, base, limiter)
        self.seq = 0
        self._thread: Optional[threading.Thread] = None
        self._backoff = Backoff()

    def get_object(self, kind: str, key: str) -> Optional[dict]:
        try:
            return _get(self.base, f"/objects/{kind}/{key}", timeout=10.0)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def list_and_seed(self) -> None:
        """The initial LIST: seed the cache, remember the watch cursor.  A
        RE-list (watch horizon lost) is a full store REPLACE, like the
        reference informer's relist: pods apply as updates (stable uids make
        that idempotent), and anything cached that the LIST no longer carries
        is deleted — an object deleted during the horizon gap (its delete
        event pruned from the server's bounded history) must not survive as a
        ghost holding node resources."""
        relist = self.synced.is_set()
        if self.limiter is not None:
            # LIST/relist shares the outbound QPS budget; the watch
            # long-poll below deliberately does not (see connect_cache).
            self.limiter.acquire()
        state = _get(self.base, "/state")
        self.seq = int(state.get("seq", 0))
        for q in state.get("queues", []):
            self._apply("queue", "add", q)
        for pc in state.get("priorityClasses", []):
            self._apply("priorityclass", "add", pc)
        for n in state.get("nodes", []):
            self._apply("node", "update" if relist else "add", n)
        for g in state.get("podGroups", []):
            self._apply("podgroup", "update" if relist else "add", g)
        for p in state.get("pods", []):
            self._apply("pod", "update" if relist else "add", p)
        if relist:
            removed = self.cache.prune_absent(
                pod_uids={pod_uid(p) for p in state.get("pods", [])},
                node_names={obj_name(n) for n in state.get("nodes", [])},
                podgroup_keys={pod_key(g) for g in state.get("podGroups", [])},
                queue_names={obj_name(q) for q in state.get("queues", [])},
                priority_class_names={
                    obj_name(pc) for pc in state.get("priorityClasses", [])
                },
            )
            if removed:
                logger.warning("relist pruned %d ghost objects", removed)
        self.synced.set()

    def _watch_loop(self) -> None:
        # LIST first, with retries: the daemon and its system of record start
        # concurrently in any orchestrated deploy — a refused connection at
        # boot must resync, not crash (cache.Run/WaitForCacheSync semantics).
        # All retry paths back off with jittered exponential delays (shared
        # Backoff, reset on any success): a dead server must not be hammered
        # at a fixed cadence by a fleet of reconnecting schedulers.
        while not self._stop.is_set() and not self.synced.is_set():
            try:
                self.list_and_seed()
                self._backoff.reset()
            except Exception:
                logger.warning("initial LIST failed; retrying", exc_info=True)
                self._stop.wait(self._backoff.next())
        while not self._stop.is_set():
            try:
                payload = _get(
                    self.base, f"/watch?since={self.seq}&timeout=5", timeout=30
                )
                self._backoff.reset()
            except Exception:
                if self._stop.is_set():
                    return
                logger.warning("watch poll failed; retrying", exc_info=True)
                self._stop.wait(self._backoff.next())
                continue
            if payload.get("relist") or self._dirty:
                # Watch horizon passed our cursor ("resourceVersion too
                # old"), or an event failed to apply: re-LIST.  The relist is
                # a full store replace (upserts + ghost pruning), so either
                # divergence heals the same way.
                self._dirty = False
                try:
                    self.list_and_seed()
                    self._backoff.reset()
                except Exception:
                    self._dirty = True
                    logger.warning("relist failed; retrying", exc_info=True)
                    self._stop.wait(self._backoff.next())
                continue
            for event in payload.get("events", []):
                self.seq = max(self.seq, int(event["seq"]))
                self._apply(event["kind"], event["op"], event["object"])

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._watch_loop, name="connector-watch", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._close_status_updater()


def wire_from_env() -> str:
    """The inbound wire protocol as configured by ``SCHEDULER_TORCH_WIRE``:
    ``k8s`` (default — per-resource LIST+WATCH reflectors with
    resourceVersion cursors, connector/reflector.py) or ``journal`` (the
    bespoke ``GET /state`` + ``GET /watch?since`` journal).  The default
    flipped to ``k8s`` once the churn-soak evidence landed (docs/INGEST.md
    "Default wire"); reverting is this one line."""
    from scheduler_tpu_torch.utils.envflags import env_str

    return env_str("SCHEDULER_TORCH_WIRE", "k8s", choices=("journal", "k8s"))


def connect_cache(
    base: str,
    scheduler_name: str = "volcano",
    default_queue: str = "default",
    io_workers: Optional[int] = None,
    vocab: Optional[ResourceVocabulary] = None,
    async_io: bool = True,
    dialect: str = "k8s",
    limiter: Optional[TokenBucket] = None,
    wire: Optional[str] = None,
) -> tuple:
    """A SchedulerCache whose side effects cross the wire to ``base``.
    Returns ``(cache, connector)`` — call ``connector.start()`` after
    ``cache.run()`` and ``connector.stop()`` at shutdown.

    ``dialect`` selects the OUTBOUND wire shapes: ``"k8s"`` (default) emits
    real Kubernetes API calls — pods/binding POSTs, pod DELETEs, status
    subresource PATCHes, v1 Events, PVC annotation PATCHes — so the
    connector can front a real API server; ``"legacy"`` keeps the compact
    bespoke JSON RPCs for older servers.

    ``wire`` selects the INBOUND ingestion protocol (docs/INGEST.md):
    ``"k8s"`` (default) ingests the way client-go does — per-resource LIST
    (``/api/v1/pods``, …) + chunked WATCH streams with resourceVersion
    cursors and ``410 Gone`` relist recovery (connector/reflector.py);
    ``"journal"`` keeps the bespoke global-journal long-poll.
    ``None`` reads ``SCHEDULER_TORCH_WIRE``.

    ``limiter`` rate-limits the outbound RPCs (binds, evictions, status
    writes, events, volume claims) AND the inbound LISTs/relists through
    ONE shared token bucket — the reference's single kube-client QPS/burst
    budget.  ``None`` reads ``SCHEDULER_TORCH_QPS`` / ``SCHEDULER_TORCH_BURST``
    (unset = unlimited).  The inbound watch long-polls are deliberately
    outside the budget: each is a single sequential poller whose rate the
    server's stream timeout already bounds, and starving ingestion behind a
    bind backlog would stall cache sync — but a LIST is a full-inventory
    burst (and a relist storm is the classic thundering herd), so those pay.
    Advisory lifecycle events DO share the budget — that is the reference's
    behavior too (client-go's event broadcaster posts through the same
    rate-limited client), and it means a large event backlog paces binds;
    size QPS for both, or pass a bigger dedicated ``limiter`` here (the
    event queue is bounded at ``K8sStatusUpdater._QUEUE_CAP`` and sheds
    oldest-first, so the tax is bounded)."""
    if limiter is None:
        limiter = rate_limiter_from_env()
    if dialect == "k8s":
        binder, evictor = K8sBinder(base, limiter), K8sEvictor(base, limiter)
        status = K8sStatusUpdater(base, limiter)
        volumes = K8sVolumeBinder(base, limiter)
    elif dialect == "legacy":
        binder, evictor = HttpBinder(base, limiter), HttpEvictor(base, limiter)
        status = HttpStatusUpdater(base, limiter)
        volumes = HttpVolumeBinder(base, limiter)
    else:
        raise ValueError(f"unknown wire dialect {dialect!r}")
    cache = SchedulerCache(
        scheduler_name=scheduler_name,
        default_queue=default_queue,
        vocab=vocab,
        binder=binder,
        evictor=evictor,
        status_updater=status,
        volume_binder=volumes,
        async_io=async_io,
        io_workers=io_workers,
    )
    if wire is None:
        wire = wire_from_env()
    if wire == "k8s":
        from scheduler_tpu_torch.connector.reflector import K8sApiConnector

        connector: ConnectorBase = K8sApiConnector(cache, base, limiter=limiter)
    elif wire == "journal":
        connector = ApiConnector(cache, base, limiter=limiter)
    else:
        raise ValueError(f"unknown inbound wire protocol {wire!r}")
    cache.client = lambda: connector  # the reference Cache.Client() slot
    return cache, connector
