"""Where the port's binds over the wire depart from the JAX package's, both
packages are driven and each test states each one's outcome: a bind whose
POST got no answer but which the server applies later, and an unbound view
of a pod (a relist's LIST from before its bind landed) that arrives while
the bind is in flight.  The JAX package puts the pod back to pending in
both, and its next cycle gives the pod's room to another pod, so the node
ends overcommitted; the port keeps the pod where its bind put it.  The
wire cases run each package's mock server as a process of its own through
``test_torch_daemon_wire.drive``; every wait is bounded (at most 20 s)."""

from __future__ import annotations

import json

import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.apis.objects as jax_objects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.apis.objects as torch_objects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu.scheduler import Scheduler as JaxScheduler
from scheduler_tpu_torch.harness import wire_rig
from scheduler_tpu_torch.scheduler import Scheduler as TorchScheduler
from test_torch_daemon_wire import (
    CONFIG2_CONF,
    JAX,
    TORCH,
    _cached_pods,
    _wait,
    conf,  # noqa: F401  the fixture
    drive,
)


# One node with room for one pod, and a PodGroup whose second pod, p2,
# outranks p1 in task order (pod priority): a cycle that finds the node
# free gives it to p2.
CONTESTED = {
    "queues": [{"name": "default", "weight": 1}],
    "nodes": [{"name": "n0", "allocatable": {"cpu": 1000, "memory": 2**30, "pods": 110}}],
    "podGroups": [{"name": "grp", "queue": "default", "minMember": 1, "phase": "Inqueue"}],
    "pods": [{"name": "p1", "group": "grp", "priority": 0,
              "containers": [{"cpu": 1000, "memory": 2**28}]}],
}
P2 = {"name": "p2", "group": "grp", "priority": 10,
      "containers": [{"cpu": 1000, "memory": 2**28}]}


class HeldBind:
    """Stands in for a connector module's ``_request``: the first bind POST
    does not reach the server and raises a timeout, as a POST whose answer
    never came; ``release`` sends it later, as a server that applies it
    late."""

    PATHS = ("/bind", "/bind-bulk", "/binding")

    def __init__(self, module):
        self.send, self.held = module._request, None

    def __call__(self, base, path, payload, method, *args, **kwargs):
        if self.held is None and method == "POST" and path.endswith(self.PATHS):
            self.held = (base, path, payload)
            raise TimeoutError("timed out")
        return self.send(base, path, payload, method, *args, **kwargs)

    def release(self):
        base, path, payload = self.held
        self.send(base, path, payload, "POST")


@pytest.mark.parametrize("dialect", ["k8s", "legacy"])
def test_bind_answered_late_is_not_placed_twice(conf, monkeypatch, dialect):
    """Cycle 1 binds p1 to n0 and its POST times out; p2 arrives; cycle 2
    runs; then the server applies the first POST.  The JAX connector gives
    the bind up at once: its cache puts p1 back to pending, cycle 2 binds p2
    to n0, and the late POST lands p1 beside it.  The port sends the POST
    again until the server answers, so n0 stays p1's and p2 waits."""
    import scheduler_tpu.connector.client as jax_client
    import scheduler_tpu_torch.connector.client as torch_client

    path = conf(CONFIG2_CONF)
    outcome = {}
    for pkg, module in ((JAX, jax_client), (TORCH, torch_client)):
        held = HeldBind(module)
        monkeypatch.setattr(module, "_request", held)

        def settle(cache, base):
            wire_rig.http_json(base, "/objects", {"kind": "pod", "object": P2})
            assert _wait(lambda: "p2" in _cached_pods(cache))

        def finish(cache, base):
            held.release()
            state = wire_rig.http_json(base, "/state")
            outcome[pkg] = wire_rig.overcommitted(state["nodes"], state["pods"])

        binds, _ = drive(pkg, CONTESTED, path, dialect=dialect, cycles=2, settle=settle,
                         finish=finish)
        monkeypatch.setattr(module, "_request", held.send)
        assert held.held is not None
        outcome[pkg] = (outcome[pkg], [b["pod"] for b in binds])
    assert outcome[JAX] == (["n0"], ["default/p2", "default/p1"])
    assert outcome[TORCH] == ([], ["default/p1", "default/p1"])


def test_unbound_view_while_the_bind_is_in_flight(conf):
    """While p1's bind is in flight, the cache takes in p1 as a LIST from
    before the bind landed shows it: unbound.  The JAX cache puts p1 back to
    pending and its next cycle binds p2 to n0 too; the port's keeps p1 on n0
    until the bind's own outcome comes back."""
    import scheduler_tpu.cache.cache as jax_cache
    import scheduler_tpu.cache.fakes as jax_fakes
    import scheduler_tpu.cli as jax_cli
    import scheduler_tpu.connector.wire as jax_wire
    import scheduler_tpu_torch.cache.cache as torch_cache
    import scheduler_tpu_torch.cache.fakes as torch_fakes
    import scheduler_tpu_torch.cli as torch_cli
    import scheduler_tpu_torch.connector.wire as torch_wire

    conf_path = conf(CONFIG2_CONF)
    state_path = conf_path.parent / "contested.json"
    state_path.write_text(json.dumps(CONTESTED))
    binds = {}
    for pkg, cache_mod, fakes, cli_mod, wire, sched_cls in (
            (JAX, jax_cache, jax_fakes, jax_cli, jax_wire, JaxScheduler),
            (TORCH, torch_cache, torch_fakes, torch_cli, torch_wire, TorchScheduler)):

        class StaleViewBinder(fakes.FakeBinder):
            """Before the first bind it records, the cache takes in p1's
            stale, unbound view."""

            seen = False

            def _stale_view(self):
                if not self.seen:
                    self.seen = True
                    cache.update_pod(wire.parse_pod(CONTESTED["pods"][0], cache.scheduler_name))

            def bind(self, pod, hostname):
                self._stale_view()
                super().bind(pod, hostname)

            def bind_bulk(self, pairs):
                self._stale_view()
                super().bind_bulk(pairs)

            def bind_rows(self, pods, hostnames):
                self._stale_view()
                super().bind_rows(pods, hostnames)

        cache = cache_mod.SchedulerCache(async_io=False, binder=StaleViewBinder())
        objects = jax_objects if pkg == JAX else torch_objects
        with wire_rig.ObjectClock(objects):
            cli_mod.load_cluster_state(cache, str(state_path))
            sched = sched_cls(cache, str(conf_path)) if pkg == JAX else \
                sched_cls(cache, str(conf_path), device="cpu")
            sched.run_once()
            cache.add_pod(wire.parse_pod(P2, cache.scheduler_name))
            sched.run_once()
        binds[pkg] = dict(cache.binder.binds)
    assert binds[JAX] == {"default/p1": "n0", "default/p2": "n0"}
    assert binds[TORCH] == {"default/p1": "n0"}


def test_unanswered_bind_is_sent_until_answered_or_closed(monkeypatch):
    """``_post_bind`` sends a bind that got no answer again, unchanged, until
    the server answers; once its binder is closed (the cache is stopping)
    the failure raises; an HTTP error is the server's answer and is not
    sent again."""
    import io
    import threading
    import urllib.error

    import scheduler_tpu_torch.connector.client as client

    sends = []

    def answers_third(base, path, payload, method, *args, **kwargs):
        sends.append(payload)
        if len(sends) < 3:
            raise TimeoutError("timed out")
        return {"ok": True}

    monkeypatch.setattr(client, "_request", answers_third)
    closed = threading.Event()
    assert client._post_bind("http://server", "/bind", {"name": "p1"}, closed) == {"ok": True}
    assert sends == [{"name": "p1"}] * 3

    sends.clear()

    def never_answers(base, path, payload, method, *args, **kwargs):
        sends.append(payload)
        raise urllib.error.URLError(TimeoutError("timed out"))

    monkeypatch.setattr(client, "_request", never_answers)
    timer = threading.Timer(0.25, closed.set)
    timer.start()
    with pytest.raises(urllib.error.URLError):
        client._post_bind("http://server", "/bind", {"name": "p1"}, closed)
    timer.join()
    assert len(sends) >= 2

    sends.clear()
    closed.clear()

    def refuses(base, path, payload, method, *args, **kwargs):
        sends.append(payload)
        raise urllib.error.HTTPError(base + path, 409, "Conflict", {}, io.BytesIO(b"{}"))

    monkeypatch.setattr(client, "_request", refuses)
    with pytest.raises(urllib.error.HTTPError):
        client._post_bind("http://server", "/bind", {"name": "p1"}, closed)
    assert len(sends) == 1
