"""Leader election: the active/standby analogue, over a pluggable lease lock.

Reference: ``cmd/kube-batch/app/server.go:111-152`` — the lock is a ConfigMap
resource lock IN THE SHARED STORE (the API server), LeaseDuration 15s /
RenewDeadline 10s / RetryPeriod 5s (:49-51), process exits when leadership is
lost (:147-149).

Two lock backends take that slot here:

* ``ApiLeaseLock`` — a ``coordination.k8s.io/v1`` Lease object in the system
  of record, compare-and-swapped via ``metadata.resourceVersion`` exactly the
  way client-go's resourcelock does it.  This is the reference-faithful
  backend: HA works wherever the API server is reachable.
* ``FileLeaseLock`` — a lease file on disk; atomic-replace + an
  O_CREAT|O_EXCL claim file serialize contended acquires.  Only provides HA
  between schedulers sharing that filesystem (the standalone/daemon-on-one-
  host mode); deployments fronting an API server get ``ApiLeaseLock``
  automatically (cli.py).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid
from datetime import datetime, timezone
from typing import Callable, Optional

logger = logging.getLogger("scheduler_tpu_torch.leaderelection")

LEASE_DURATION = 15.0
RENEW_DEADLINE = 10.0
RETRY_PERIOD = 5.0

# "Never observed a lease yet" — must compare unequal to every wire
# resourceVersion INCLUDING a missing one (None), see ApiLeaseLock.
_RV_UNSEEN = object()


class FileLeaseLock:
    """(holder, renewed) lease in a file; see module docstring for scope."""

    def __init__(self, lock_file: str, identity: str,
                 lease_duration: float = LEASE_DURATION) -> None:
        self.lock_file = lock_file
        self.identity = identity
        self.lease_duration = lease_duration

    def _read(self) -> Optional[dict]:
        try:
            with open(self.lock_file, "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write(self) -> None:
        """Atomic replace so a crashed writer never leaves a torn lease."""
        tmp = f"{self.lock_file}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump({"holder": self.identity, "renewed": time.time()}, f)
        os.replace(tmp, self.lock_file)

    def _other_holds_live_lease(self) -> bool:
        lease = self._read()
        return (
            lease is not None
            and lease.get("holder") != self.identity
            and time.time() - float(lease.get("renewed", 0.0)) < self.lease_duration
        )

    def try_acquire_or_renew(self) -> bool:
        if self._other_holds_live_lease():
            return False
        lease = self._read()
        if lease is not None and lease.get("holder") == self.identity:
            self._write()  # uncontended renew of our own lease
            return True
        # Contended acquire (absent/expired lease): serialize the
        # read-check-write through an O_CREAT|O_EXCL claim file so two
        # standbys can't both observe "expired" and both lead (split brain).
        claim = f"{self.lock_file}.claim"
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # Another candidate is mid-acquire; break the claim only if its
            # owner crashed (claim older than a full lease).
            try:
                if time.time() - os.path.getmtime(claim) > self.lease_duration:
                    os.unlink(claim)
            except OSError:
                pass
            return False
        try:
            os.close(fd)
            if self._other_holds_live_lease():
                return False  # lost the race to a lease written before our claim
            self._write()
            return True
        finally:
            try:
                os.unlink(claim)
            except OSError:
                pass

    def release(self) -> None:
        """Drop the lease if still ours so a standby takes over instantly."""
        lease = self._read()
        if lease is not None and lease.get("holder") == self.identity:
            try:
                os.unlink(self.lock_file)
            except OSError:
                pass


class ApiLeaseLock:
    """A ``coordination.k8s.io/v1`` Lease in the API server, CAS'd on
    ``metadata.resourceVersion`` (client-go resourcelock semantics): create
    when absent, renew our own, take over an expired one — every write
    carries the resourceVersion it read, so two standbys observing the same
    expired lease cannot both win (the second PUT 409s)."""

    def __init__(
        self,
        base: str,
        identity: str,
        name: str = "scheduler-tpu",
        namespace: str = "kube-system",
        lease_duration: float = LEASE_DURATION,
    ) -> None:
        self.base = base.rstrip("/")
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.path = (
            f"/apis/coordination.k8s.io/v1/namespaces/{namespace}"
            f"/leases/{name}"
        )
        # Locally observed lease staleness (client-go leaderelection
        # semantics): the rv we last saw and WHEN we saw it on our own
        # monotonic clock.  Expiry is judged from these, never from the
        # holder's renewTime, so clock skew between hosts cannot trigger a
        # premature takeover.  The never-observed sentinel must be distinct
        # from any wire value — a lease whose metadata carries NO
        # resourceVersion (rv=None) still gets a first observation that
        # starts the staleness clock rather than reading as stale-since-boot.
        self._observed_rv: object = _RV_UNSEEN
        self._observed_at: float = 0.0

    # -- wire ---------------------------------------------------------------

    def _request(self, method: str, path: str, payload: Optional[dict]):
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read() or b"{}")

    def _now(self) -> str:
        return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")

    def _spec(self) -> dict:
        # leaseDurationSeconds is int32 on the real wire — a real API server
        # rejects floats, so round (never truncate: 15.9 -> 16, not a
        # silently shortened 15) and clamp to >= 1 (0 == instantly expired).
        # The true float stays in self.lease_duration for local expiry math,
        # which is where sub-second test leases actually bite.
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": max(1, round(self.lease_duration)),
            "renewTime": self._now(),
        }

    def _body(self, resource_version: Optional[str]) -> dict:
        meta = {"name": self.name, "namespace": self.namespace}
        if resource_version is not None:
            meta["resourceVersion"] = resource_version
        return {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta, "spec": self._spec(),
        }

    def _locally_expired(self, rv: Optional[str]) -> bool:
        """client-go's skew-proof expiry: a foreign lease is expired only
        after its resourceVersion has sat UNCHANGED for lease_duration of
        locally observed (monotonic) time.  Any rv movement — including the
        first observation — restarts the clock; the holder's renewTime never
        enters the decision (consulting it even once, e.g. on a standby's
        first look after a restart, would re-open the skewed-clock takeover
        of a live lease this method exists to prevent).  The cost is that a
        standby arriving at a long-dead lease idles one extra lease_duration
        before taking over — exactly client-go's behavior."""
        now = time.monotonic()
        if rv != self._observed_rv:
            self._observed_rv = rv
            self._observed_at = now
            return False
        return now - self._observed_at >= self.lease_duration

    # -- lock protocol ------------------------------------------------------

    def try_acquire_or_renew(self) -> bool:
        try:
            lease = self._request("GET", self.path, None)
        except urllib.error.HTTPError as e:
            if e.code != 404:
                logger.warning("lease GET failed: %s", e)
                return False
            # Absent: create.  A racing creator 409s us — they lead.
            try:
                self._request(
                    "POST",
                    self.path.rsplit("/", 1)[0],
                    self._body(None),
                )
                return True
            except urllib.error.HTTPError as e2:
                if e2.code != 409:
                    logger.warning("lease create failed: %s", e2)
                return False
            except OSError as e2:
                # URLError/timeouts: a transient outage must read as "not
                # leading", never escape into the renew thread (a dead
                # renewer with lost/stop unset would leave a zombie leader).
                logger.warning("lease create failed: %s", e2)
                return False
        except OSError as e:
            logger.warning("lease GET failed: %s", e)
            return False

        spec = lease.get("spec", {})
        rv = (lease.get("metadata") or {}).get("resourceVersion")
        holder = spec.get("holderIdentity") or ""
        if holder and holder != self.identity and not self._locally_expired(rv):
            return False  # live lease held by another scheduler
        # empty holder == released lease: immediately acquirable via CAS
        # Renew our own, or take over an expired one — same CAS'd PUT.
        try:
            self._request("PUT", self.path, self._body(rv))
            return True
        except urllib.error.HTTPError as e:
            if e.code != 409:
                logger.warning("lease update failed: %s", e)
            return False  # lost the CAS race (or transient server error)
        except OSError as e:
            logger.warning("lease update failed: %s", e)
            return False

    def release(self) -> None:
        """CAS'd hand-back: blank the holder (client-go's release shape) only
        if the lease is still ours AT the resourceVersion we read — a plain
        GET-then-DELETE could destroy a lease a standby took over between the
        two calls (stalled-leader resume), evicting the new leader."""
        try:
            lease = self._request("GET", self.path, None)
            if lease.get("spec", {}).get("holderIdentity") != self.identity:
                return
            rv = (lease.get("metadata") or {}).get("resourceVersion")
            body = self._body(rv)
            body["spec"]["holderIdentity"] = ""
            self._request("PUT", self.path, body)
        except (urllib.error.HTTPError, OSError):
            pass  # 409 == someone else took over; nothing to hand back


class LeaderElector:
    """Blocks until the lock is held, runs the workload, exits (fatally, like
    the reference's OnStoppedLeading) when the lease cannot be renewed."""

    def __init__(
        self,
        lock_file: Optional[str] = None,
        identity: Optional[str] = None,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
        lock=None,
    ) -> None:
        self.identity = identity or f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        if lock is None:
            if lock_file is None:
                raise ValueError("LeaderElector needs a lock or a lock_file")
            lock = FileLeaseLock(lock_file, self.identity, lease_duration)
        elif callable(lock) and not hasattr(lock, "try_acquire_or_renew"):
            # Lock factory: identity lives HERE (one generator, lock and
            # elector logs always agree) — the factory receives it.
            lock = lock(self.identity)
        self.lock = lock

    def _try_acquire_or_renew(self) -> bool:
        return self.lock.try_acquire_or_renew()

    # -- run loop (leaderelection.RunOrDie equivalent) -----------------------

    def run(
        self,
        on_started_leading: Callable[[threading.Event], None],
        stop: Optional[threading.Event] = None,
    ) -> None:
        """Block until leadership, run the workload, exit when the lease is
        lost (server.go:140-151: OnStoppedLeading is fatal)."""
        stop = stop or threading.Event()
        while not stop.is_set():
            if self._try_acquire_or_renew():
                break
            logger.info("standby: lease held by another scheduler; retrying")
            stop.wait(self.retry_period)
        if stop.is_set():
            return

        logger.info("leading as %s", self.identity)
        lost = threading.Event()

        def renew_loop() -> None:
            while not stop.is_set() and not lost.is_set():
                deadline = time.time() + self.renew_deadline
                renewed = False
                while time.time() < deadline:
                    if self._try_acquire_or_renew():
                        renewed = True
                        break
                    time.sleep(min(1.0, self.retry_period))
                if not renewed:
                    logger.error("leader election lost for %s", self.identity)
                    lost.set()
                    stop.set()
                    return
                stop.wait(self.retry_period)

        renewer = threading.Thread(target=renew_loop, name="lease-renew", daemon=True)
        renewer.start()
        try:
            on_started_leading(stop)
        finally:
            stop.set()
            renewer.join(timeout=2.0)
            self.lock.release()
