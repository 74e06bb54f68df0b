"""The port's daemon surface against the JAX package's: flag parsing into
``ServerOption``, the admin and debug endpoints, the queue CLI, the cycle
trigger on a scripted clock, leader election (file lease and API lease),
the flight recorder and span tracer, ``python -m scheduler_tpu_torch`` as a
process that stops on SIGTERM, and the daemon's device rule (CUDA unless
``--device cpu``; raises without a GPU).  Every wait is bounded."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu import cli as jax_cli
from scheduler_tpu.utils.trigger import CycleTrigger as JaxTrigger
from scheduler_tpu_torch import cli, queue_cli
from scheduler_tpu_torch.cache.cache import SchedulerCache
from scheduler_tpu_torch.harness import wire_rig
from scheduler_tpu_torch.options import ServerOption
from scheduler_tpu_torch.scheduler import Scheduler
from scheduler_tpu_torch.utils import obs, trace
from scheduler_tpu_torch.utils.leaderelection import ApiLeaseLock, LeaderElector
from scheduler_tpu_torch.utils.trigger import CycleTrigger

ROOT = Path(__file__).resolve().parent.parent

STATE = {
    "queues": [{"name": "default", "weight": 1}],
    "nodes": [{"name": f"n{i}", "allocatable": {"cpu": 4000, "memory": 8 * 2**30, "pods": 110}}
              for i in range(2)],
    "podGroups": [{"name": "g", "minMember": 2, "queue": "default", "phase": "Inqueue"}],
    "pods": [{"name": f"g-{i}", "group": "g", "containers": [{"cpu": 500, "memory": 2**20}]}
             for i in range(2)],
}

CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: predicates
  - name: nodeorder
"""


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def _wait(pred, timeout=20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


ARGVS = {
    "defaults": [],
    "api_server": ["--api-server", "http://127.0.0.1:1", "--wire", "journal",
                   "--api-dialect", "legacy", "--schedule-period", "0.5"],
    "all_flags": ["--scheduler-name", "kb", "--scheduler-conf", "conf.yaml",
                  "--schedule-period", "2.5", "--default-queue", "q1",
                  "--listen-address", "127.0.0.1:0", "--leader-elect", "--lock-file",
                  "lease.lock", "--io-workers", "3", "--profile-dir", "prof", "--mesh", "1"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_main_parses_flags_as_jax(case, monkeypatch):
    """``main`` hands ``run`` the ServerOption the JAX daemon's ``main``
    hands its ``run`` for the same argv (the port's ``--device`` aside),
    and the same ``run`` arguments."""
    seen = {}

    def capture(key):
        def run(opt, stop=None, **kw):
            seen[key] = (opt, kw)

        return run

    monkeypatch.setattr(jax_cli, "run", capture("jax"))
    monkeypatch.setattr(cli, "run", capture("torch"))
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        jax_cli.main(list(ARGVS[case]))  # leaves its handlers installed
        before = {sig: signal.getsignal(sig) for sig in saved}
        cli.main(list(ARGVS[case]) + ["--device", "cpu"])
        # The port's main puts back the handlers it found.
        assert {sig: signal.getsignal(sig) for sig in saved} == before
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    (jopt, jkw), (topt, tkw) = seen["jax"], seen["torch"]
    ours = dataclasses.asdict(topt)
    assert ours.pop("device") == "cpu"
    assert ours == dataclasses.asdict(jopt)
    assert tkw == jkw


@pytest.fixture()
def cpu_cache(tmp_path):
    path = tmp_path / "state.json"
    path.write_text(json.dumps(STATE))
    cache = SchedulerCache(async_io=False)
    cli.load_cluster_state(cache, str(path))
    return cache


def test_endpoints_answer(cpu_cache, tmp_path):
    conf = tmp_path / "conf.yaml"
    conf.write_text(CONF)
    obs.reset()
    Scheduler(cpu_cache, str(conf), device="cpu").run_once()
    server = cli.serve_metrics("127.0.0.1:0", cpu_cache)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert _get(base + "/healthz") == (200, b"ok")
        status, body = _get(base + "/metrics")
        text = body.decode()
        assert status == 200
        for family in ("volcano_e2e_scheduling_latency_milliseconds",
                       "volcano_scheduler_cycles_total", "volcano_binds_total",
                       "volcano_queue_pending_depth", "volcano_time_to_bind_seconds"):
            assert family in text
        assert 'volcano_binds_total{queue="default"} 2' in text
        cycles = json.loads(_get(base + "/debug/cycles")[1])
        assert cycles["enabled"] and len(cycles["cycles"]) == 1
        rec = cycles["cycles"][0]
        assert rec["binds"] == 2 and "action:allocate" in rec["phases"]
        assert json.loads(_get(base + "/debug/trace")[1])["enabled"] is False
        assert b"--- thread" in _get(base + "/debug/threads")[1]
        rows = json.loads(_get(base + "/api/queues")[1])
        assert rows == [{"name": "default", "weight": 1, "jobs": 1}]
        req = urllib.request.Request(base + "/api/queues", method="POST",
                                     data=json.dumps({"name": "q9", "weight": 3}).encode())
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 201 and json.loads(resp.read()) == {"name": "q9"}
        assert cpu_cache.queues["q9"].weight == 3
        bad = urllib.request.Request(base + "/api/queues", method="POST", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=10)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_queue_cli_against_the_daemon(cpu_cache, capsys):
    server = cli.serve_metrics("127.0.0.1:0", cpu_cache)
    try:
        addr = f"http://127.0.0.1:{server.server_address[1]}"
        assert queue_cli.queue_create(addr, "tenant-a", 4) == {"name": "tenant-a"}
        rows = {r["name"]: r for r in queue_cli.queue_list(addr)}
        assert rows["tenant-a"]["weight"] == 4 and rows["default"]["jobs"] == 1
        assert queue_cli.main(["--server", addr, "create", "--name", "t2", "--weight", "2"]) == 0
        assert queue_cli.main(["--server", addr, "list"]) == 0
        out = capsys.readouterr().out
        assert "created queue t2" in out and "tenant-a" in out
    finally:
        server.shutdown()
        server.server_close()


class ScriptClock:
    """A clock that moves only when the trigger sleeps or the script says."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


# (debounce, min_interval, max_interval), then steps: ("at", t) sets the
# clock, ("notify", n) records n events, ("wait",) lets the trigger decide.
TRIGGER_SCRIPTS = {
    "debounce_batch": ((0.025, 0.0, 1.0), [("notify", 3), ("at", 100.01), ("notify", 2),
                                           ("wait",), ("notify", 1), ("wait",)]),
    "aged_batch": ((0.05, 0.0, 1.0), [("notify", 4), ("at", 100.2), ("wait",)]),
    "min_interval": ((0.0, 0.3, 1.0), [("notify", 1), ("wait",), ("notify", 1), ("wait",),
                                       ("at", 101.0), ("notify", 5), ("wait",)]),
    "burst_after_quiet": ((0.01, 0.05, 2.0), [("at", 103.0), ("notify", 7), ("notify", 1),
                                              ("wait",), ("notify", 2), ("wait",)]),
}


@pytest.mark.parametrize("case", sorted(TRIGGER_SCRIPTS))
def test_cycle_trigger_matches_jax_on_a_scripted_clock(case):
    (debounce, lo, hi), steps = TRIGGER_SCRIPTS[case]
    runs = []
    for cls in (JaxTrigger, CycleTrigger):
        clock = ScriptClock()
        trig = cls(debounce=debounce, min_interval=lo, max_interval=hi, clock=clock,
                   sleep=clock.sleep)
        out = []
        for step in steps:
            if step[0] == "at":
                clock.now = max(clock.now, step[1])
            elif step[0] == "notify":
                trig.notify(step[1])
            else:
                out.append((trig.wait(), round(clock.now, 9), trig.pending()))
        runs.append((out, trig.cycles, trig.total_events))
    assert runs[0] == runs[1]
    assert all(consumed > 0 for consumed, _, _ in runs[1][0])


def test_cycle_trigger_knobs_from_env_match_jax(monkeypatch):
    for name, value in (("DEBOUNCE_MS", "40"), ("TRIGGER_MIN_MS", "5"),
                        ("TRIGGER_MAX_MS", "750")):
        monkeypatch.setenv(f"SCHEDULER_TPU_{name}", value)
        monkeypatch.setenv(f"SCHEDULER_TORCH_{name}", value)
    j, t = JaxTrigger.from_env(2.0), CycleTrigger.from_env(2.0)
    assert (t.debounce, t.min_interval, t.max_interval) == \
        (j.debounce, j.min_interval, j.max_interval) == (0.04, 0.005, 0.75)
    monkeypatch.setenv("SCHEDULER_TORCH_TRIGGER_MAX_MS", "junk")
    assert CycleTrigger.from_env(0.5).max_interval == 0.5


def _workload(order, name, hold):
    def lead(stop_event):
        order.append(name)
        hold.wait(10)

    return lead


def _handover(make_elector):
    """Elector a leads, b stands by while a renews, b leads once a stops."""
    order = []
    stops = {n: threading.Event() for n in "ab"}
    holds = {n: threading.Event() for n in "ab"}
    threads = {n: threading.Thread(target=make_elector(n).run,
                                   args=(_workload(order, n, holds[n]), stops[n]), daemon=True)
               for n in "ab"}
    try:
        threads["a"].start()
        assert _wait(lambda: order == ["a"], 5)
        threads["b"].start()
        time.sleep(0.7)
        assert order == ["a"]
        holds["a"].set()
        stops["a"].set()
        assert _wait(lambda: order == ["a", "b"], 5)
    finally:
        for n in "ab":
            holds[n].set()
            stops[n].set()
        for t in threads.values():
            if t.is_alive():
                t.join(timeout=5)
    assert not any(t.is_alive() for t in threads.values())


def test_file_lease_hands_over(tmp_path):
    lock = str(tmp_path / "leader.lock")
    _handover(lambda name: LeaderElector(lock, identity=name, lease_duration=0.5,
                                         renew_deadline=0.3, retry_period=0.05))


def test_api_lease_hands_over_on_the_mock_server():
    proc, base = wire_rig.spawn_mock_server()
    try:
        _handover(lambda name: LeaderElector(
            identity=name, lease_duration=0.5, renew_deadline=0.3, retry_period=0.05,
            lock=ApiLeaseLock(base, identity=name, lease_duration=0.5)))
        lease = wire_rig.http_json(base, "/apis/coordination.k8s.io/v1/namespaces/kube-system/"
                                      "leases/scheduler-tpu")
        assert lease["spec"]["holderIdentity"] == ""  # b released it
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_trace_and_profile_write_per_cycle_files(cpu_cache, tmp_path, monkeypatch):
    conf = tmp_path / "conf.yaml"
    conf.write_text(CONF)
    monkeypatch.setenv("SCHEDULER_TORCH_TRACE", str(tmp_path / "spans"))
    monkeypatch.setenv("SCHEDULER_TORCH_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("SCHEDULER_TORCH_PROFILE_EVERY", "1")
    obs.reset()
    trace.reset()
    try:
        Scheduler(cpu_cache, str(conf), device="cpu").run_once()
        spans = sorted((tmp_path / "spans").iterdir())
        assert [p.name for p in spans] == ["cycle00000001.trace.json"]
        names = {e["name"] for e in json.loads(spans[0].read_text())["traceEvents"]}
        assert {"cycle", "open_session", "action:allocate", "close_session"} <= names
        assert (tmp_path / "prof" / "cycle00000001.pt.trace.json").is_file()
        assert trace.status()["profile"]["taken"] == 1
    finally:
        trace.reset()


def test_profile_dir_traces_the_first_cycles(cpu_cache, tmp_path):
    conf = tmp_path / "conf.yaml"
    conf.write_text(CONF)
    sched = Scheduler(cpu_cache, str(conf), profile_dir=str(tmp_path / "xp"), device="cpu")
    for _ in range(Scheduler.PROFILE_CYCLES + 1):
        sched.run_once()
    assert sorted(p.name for p in (tmp_path / "xp").iterdir()) == [
        f"cycle{i:04d}.json" for i in range(Scheduler.PROFILE_CYCLES)]


def test_python_m_daemon_stops_on_sigterm(tmp_path):
    state = tmp_path / "state.json"
    state.write_text(json.dumps(STATE))
    conf = tmp_path / "conf.yaml"
    conf.write_text(CONF)
    port = wire_rig.free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "scheduler_tpu_torch", "--device", "cpu",
         "--cluster-state", str(state), "--scheduler-conf", str(conf),
         "--schedule-period", "0.2", "--listen-address", f"127.0.0.1:{port}"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        def cycled():
            try:
                return json.loads(_get(f"http://127.0.0.1:{port}/debug/cycles", 2)[1])["cycles"]
            except OSError:
                return False

        assert _wait(cycled, 30), proc.stderr.read() if proc.poll() is not None else ""
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_daemon_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(ServerOption(listen_address="127.0.0.1:0"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--listen-address", "127.0.0.1:0"])
    with pytest.raises(NotImplementedError, match="mesh"):
        cli.run(ServerOption(listen_address="127.0.0.1:0", mesh="2", device="cpu"))
    assert threading.active_count() == before  # nothing was started


def test_importing_main_starts_nothing():
    code = ("import threading, scheduler_tpu_torch.__main__ as m; "
            "print(threading.active_count(), hasattr(m, 'main'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1", "True"]


def test_module_import_is_cheap_and_version_prints(capsys):
    importlib.import_module("scheduler_tpu_torch.__main__")
    cli.main(["--version"])
    assert capsys.readouterr().out.startswith("scheduler-tpu-torch ")
