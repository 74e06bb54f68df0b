"""Helpers that drive a mock API server from outside: start one in a process
of its own, put a cluster's documents into it, read it back, and check the
store that a churn run leaves.  ``chip_smoke.py``'s wire paths and the wire
tests share them."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List, Tuple


class ObjectClock:
    """Within the block, the wall clock that stamps new API objects (a
    shadow PodGroup's creation time, in ``apis.objects.now``) of each
    package module given is a fake one: strictly increasing by 1 µs a call
    from a whole second.  A session orders jobs by the whole second of that
    stamp first, so two caches that ingest the same pods would order their
    jobs apart wherever one of them straddles a second boundary; under this
    clock neither does, and both order their jobs as they ingested them.
    Each ``with`` starts the clock again."""

    T0 = 1_800_000_000.0

    def __init__(self, *modules):
        self.modules = modules

    def time(self):
        self.calls += 1
        return self.T0 + self.calls * 1e-6

    def __enter__(self):
        self.calls = 0
        self.saved = [m.time for m in self.modules]
        for m in self.modules:
            m.time = self
        return self

    def __exit__(self, *exc):
        for m, saved in zip(self.modules, self.saved):
            m.time = saved


def spawn_mock_server(pkg: str = "scheduler_tpu_torch", cwd: str = None):
    """Package ``pkg``'s mock API server in a process of its own on a free
    port (``--port 0``; it prints the port it bound), run from ``cwd`` (by
    default the directory that holds this package).  Returns (process, base
    URL); the caller ends the process."""
    if cwd is None:
        cwd = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.connector.mock_server", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=cwd)
    line = proc.stdout.readline()
    if "mock apiserver" not in line:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"the mock API server did not start: {line!r}")
    return proc, f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"


def http_json(base, path, payload=None, method=None, timeout=30.0):
    """One JSON request to ``base + path`` (a POST where ``payload`` is given)."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
    return json.loads(body or b"{}")


def post_documents(base, docs, threads=1):
    """Create the documents of a cluster-state dict on a mock API server,
    one ``POST /objects`` an object: queues, nodes, PodGroups, pods, each
    kind in its order (``threads`` POSTs at a time; the store keeps the
    order in which the kind's objects arrive, so a kind of more than one
    object goes one at a time where ``threads`` is 1)."""
    from concurrent.futures import ThreadPoolExecutor

    for key, kind in (("queues", "queue"), ("nodes", "node"), ("podGroups", "podgroup"),
                      ("pods", "pod")):
        objs = docs.get(key, [])
        if threads <= 1:
            for obj in objs:
                http_json(base, "/objects", {"kind": kind, "object": obj})
            continue
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda obj: http_json(base, "/objects", {"kind": kind, "object": obj}),
                          objs))


def free_port():
    """A TCP port that was free a moment ago (for the daemon's endpoint)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def server_node_name(pod):
    """A mock-server pod's node, in either document dialect."""
    if isinstance(pod.get("metadata"), dict):
        return (pod.get("spec") or {}).get("nodeName") or ""
    return pod.get("nodeName") or ""


def _room(node_docs, pod_docs):
    """Each node's room left in (cpu, memory) once the pods bound to it
    (wire documents, either dialect) are counted, and the unbound pods'
    (name, request) pairs."""
    from scheduler_tpu_torch.connector.wire import parse_node, parse_pod

    room = {}
    for doc in node_docs:
        node = parse_node(doc)
        room[node.name] = [node.allocatable["cpu"], node.allocatable["memory"]]
    pending = []
    for doc in pod_docs:
        pod = parse_pod(doc)
        req = [sum(c.get("cpu", 0.0) for c in pod.containers),
               sum(c.get("memory", 0.0) for c in pod.containers)]
        if pod.node_name:
            left = room[pod.node_name]
            for i in range(2):
                left[i] -= req[i]
        else:
            pending.append((pod.name, req))
    return room, pending


def overcommitted(node_docs, pod_docs) -> List[str]:
    """The names of the nodes whose bound pods request more cpu or memory
    than the node has."""
    room, _ = _room(node_docs, pod_docs)
    return [name for name, left in room.items() if min(left) < 0]


def churn_state(state) -> Tuple[List[str], int, int]:
    """The store of a ``mock_server.MockState`` after the churn rig: its
    faults (a node overcommitted in cpu or memory; a pending pod that fits
    on a node's room, that is an arrival that fits and was not bound), and
    the counts of bound and pending pods.  ``CHURN_CONF`` has no predicates
    plugin, so a node's pod limit is no constraint there."""
    with state.lock:
        node_docs = list(state.objects["node"].values())
        pod_docs = list(state.objects["pod"].values())
    room, pending = _room(node_docs, pod_docs)
    faults = []
    over = [name for name, left in room.items() if min(left) < 0]
    if over:
        faults.append(f"{len(over)} nodes overcommitted, e.g. {over[:3]}")
    fits = [name for name, req in pending
            if any(all(left[i] >= req[i] for i in range(2)) for left in room.values())]
    if fits:
        faults.append(f"{len(fits)} pending pods fit a node's room, e.g. {fits[:3]}")
    return faults, len(pod_docs) - len(pending), len(pending)
