"""The port's connector and mock API server against the JAX package's: the
same documents go to the JAX mock server with the JAX connector and to the
port's mock server (each a process of its own) with the port's connector
(``device="cpu"``).  Each side runs ``connect_cache`` -> ``start`` ->
``wait_for_cache_sync`` -> ``Scheduler.run_once()`` and the servers'
``/bind-log`` sequences must be equal, in order: config 2's plugins on both
inbound wires, the five-action conf (proportion's water-fill on the JAX side
through its host flavor, ``SCHEDULER_TPU_QFAIR=host``), a bind that fails
once (HTTP 500) and heals, and the port's two wires against each other.

Both packages stamp shadow PodGroups with the wall clock and order jobs by
its whole second first; each side runs under ``wire_rig.ObjectClock`` so
that neither straddles a second boundary.  Every wait is bounded (at most
20 s) and every server process ends in the test's ``finally``.
"""

from __future__ import annotations

import time

import pytest

import chip_smoke as smoke
import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.apis.objects as jax_objects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.apis.objects as torch_objects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu.connector import connect_cache as jax_connect
from scheduler_tpu.scheduler import Scheduler as JaxScheduler
from scheduler_tpu_torch.connector import connect_cache as torch_connect
from scheduler_tpu_torch.harness import kubemark_density_documents, wire_rig
from scheduler_tpu_torch.scheduler import Scheduler as TorchScheduler

JAX, TORCH = "scheduler_tpu", "scheduler_tpu_torch"

# BASELINE config 2's plugins (chip_smoke.CONFIG2_CONF).
CONFIG2_CONF = smoke.CONFIG2_CONF

# The reference's production conf (tests/test_connector_evict.py): all five
# actions.
FIVE_ACTIONS_CONF = """
actions: "enqueue, reclaim, allocate, backfill, preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
  - name: proportion
  - name: predicates
  - name: nodeorder
"""


def reclaim_documents() -> dict:
    """test_connector_evict.py's reclaim cluster: q1 holds the one node with
    three running pods, q2's gang waits (created Pending, so enqueue admits
    it), and a BestEffort pod for backfill."""
    return {
        "queues": [{"name": n, "weight": 1} for n in ("default", "q1", "q2")],
        "nodes": [{"name": "big-0", "allocatable": {
            "cpu": 3000, "memory": 3 * 2**30, "pods": 110}}],
        "podGroups": [
            {"name": "fat", "queue": "q1", "minMember": 1, "phase": "Running"},
            {"name": "thin", "queue": "q2", "minMember": 1, "phase": "Pending"},
            {"name": "be", "queue": "q1", "minMember": 1, "phase": "Inqueue"},
        ],
        "pods": [
            *({"name": f"fat-{i}", "group": "fat", "nodeName": "big-0", "phase": "Running",
               "containers": [{"cpu": 1000, "memory": 2**30}]} for i in range(3)),
            {"name": "thin-0", "group": "thin",
             "containers": [{"cpu": 1000, "memory": 2**30}]},
            {"name": "be-0", "group": "be", "containers": [{}]},
        ],
    }


def _wait(pred, timeout=20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return pred()


def _cached_pods(cache) -> set:
    with cache.mutex:
        return {t.name for j in cache.jobs.values() for t in j.tasks.values()}


def drive(pkg, docs, conf_path, wire="k8s", dialect="k8s", cycles=1, inject=None,
          settle=None, finish=None):
    """Serve ``docs`` from ``pkg``'s mock server, ingest them through
    ``pkg``'s connector on ``wire``, run ``cycles`` cycles of ``pkg``'s
    ``Scheduler.run_once`` (``settle(cache, base)`` between them, and
    ``finish(cache, base)`` after the last), and return the server's bind
    log and its pods' names."""
    proc, base = wire_rig.spawn_mock_server(pkg)
    cache = conn = None
    try:
        wire_rig.post_documents(base, docs)
        if inject is not None:
            wire_rig.http_json(base, "/inject", inject)
        connect = jax_connect if pkg == JAX else torch_connect
        cache, conn = connect(base, async_io=False, wire=wire, dialect=dialect)
        if wire == "k8s":
            for r in conn.reflectors:
                r.watch_timeout = 1.0
        objects = jax_objects if pkg == JAX else torch_objects
        with wire_rig.ObjectClock(objects):
            cache.run()
            conn.start()
            assert conn.wait_for_cache_sync(15)
            sched = JaxScheduler(cache, str(conf_path)) if pkg == JAX else \
                TorchScheduler(cache, str(conf_path), device="cpu")
            for cycle in range(cycles):
                if cycle and settle is not None:
                    settle(cache, base)
                sched.run_once()
            if finish is not None:
                finish(cache, base)
        binds = wire_rig.http_json(base, "/bind-log")["binds"]
        pods = sorted(p.get("name") or p["metadata"]["name"]
                      for p in wire_rig.http_json(base, "/state")["pods"])
        return binds, pods
    finally:
        if conn is not None:
            conn.stop()
        if cache is not None:
            cache.stop()
        proc.terminate()
        proc.wait(timeout=10)


@pytest.fixture()
def conf(tmp_path):
    def write(text):
        path = tmp_path / "scheduler.yaml"
        path.write_text(text)
        return path

    return write


@pytest.mark.parametrize("wire", ["k8s", "journal"])
def test_config2_binds_as_jax_on_both_wires(conf, wire):
    docs = kubemark_density_documents(16, 120)
    path = conf(CONFIG2_CONF)
    jax_binds, _ = drive(JAX, docs, path, wire)
    ours, _ = drive(TORCH, docs, path, wire)
    assert len(jax_binds) == 120
    assert ours == jax_binds


def test_five_action_conf_binds_as_jax(conf, monkeypatch):
    """Reclaim evicts one of q1's pods over the wire; once its delete echoes
    back, allocate binds q2's pod and backfill the BestEffort one."""
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "host")
    path = conf(FIVE_ACTIONS_CONF)

    def settle(cache, base):
        # The eviction's delete echoes back to the cache.
        _wait(lambda: len([p for p in wire_rig.http_json(base, "/state")["pods"]
                           if p["name"].startswith("fat-")]) < 3)
        _wait(lambda: sum(n.startswith("fat-") for n in _cached_pods(cache)) < 3)

    jax_binds, jax_pods = drive(JAX, reclaim_documents(), path, cycles=3, settle=settle)
    assert {"pod": "default/thin-0", "node": "big-0"} in jax_binds, jax_binds
    ours, pods = drive(TORCH, reclaim_documents(), path, cycles=3, settle=settle)
    assert ours == jax_binds
    assert pods == jax_pods and len(pods) == 4


@pytest.mark.parametrize("wire", ["k8s", "journal"])
def test_injected_bind_failure_heals_as_in_jax(conf, wire):
    """The first bind POST answers 500: the pod is re-fetched from the server
    (the syncTask seam), stays pending, and the next cycle binds it."""
    docs = kubemark_density_documents(8, 24)
    path = conf(CONFIG2_CONF)
    inject = {"op": "bind", "times": 1}
    jax_binds, _ = drive(JAX, docs, path, wire, cycles=2, inject=inject)
    ours, _ = drive(TORCH, docs, path, wire, cycles=2, inject=inject)
    assert len(jax_binds) == 24
    assert ours == jax_binds


@pytest.mark.parametrize("dialect", ["k8s", "legacy"])
def test_journal_and_k8s_wires_bind_identically(conf, dialect):
    docs = kubemark_density_documents(16, 120)
    path = conf(CONFIG2_CONF)
    journal, _ = drive(TORCH, docs, path, "journal", dialect)
    k8s, _ = drive(TORCH, docs, path, "k8s", dialect)
    assert len(journal) == 120
    assert journal == k8s

