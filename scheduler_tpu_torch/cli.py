"""Scheduler daemon entrypoint: ``python -m scheduler_tpu_torch``.

Reference: ``cmd/kube-batch/main.go`` + ``cmd/kube-batch/app/server.go`` —
flag parsing, action/plugin registration by import (main.go:36-41), the
/metrics HTTP endpoint on --listen-address (server.go:96-99, plus /healthz per
doc/design/metrics.md's liveness idea and /debug/threads as the pprof
stand-in), optional leader election (server.go:111-152), then the scheduler
loop.  The JAX package's daemon (``scheduler_tpu/cli.py``) with its flags,
plus ``--device``: the cycles run on CUDA unless ``--device cpu`` asks for
the kernels' plain versions, and with no GPU the daemon raises.

Cluster-state ingestion: ``--api-server URL`` lists and watches a system of
record (``connector/``); without one the daemon can preload a cluster from
a JSON file (--cluster-state) or mass-generate a synthetic one (--synthetic
N,P); a library embedder constructs SchedulerCache and calls
add_pod/add_node/... directly.
"""

from __future__ import annotations

import json
import os
import logging
import signal
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from scheduler_tpu_torch.apis.objects import Queue
from scheduler_tpu_torch.cache.cache import SchedulerCache
from scheduler_tpu_torch.options import ServerOption, option_from_namespace, register_options
from scheduler_tpu_torch.utils import metrics
from scheduler_tpu_torch.utils.leaderelection import LeaderElector

logger = logging.getLogger("scheduler_tpu_torch.cli")


class _MetricsHandler(BaseHTTPRequestHandler):
    cache: Optional[SchedulerCache] = None  # set by serve_metrics

    def _respond(self, body: bytes, ctype: str, status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path.startswith("/metrics"):
            # Reference-shaped collectors (utils/metrics.py) + the flight
            # recorder's serving families (utils/obs.py: queue depth,
            # time-to-bind quantiles, engine-cache hit rate, relist bytes).
            from scheduler_tpu_torch.utils import obs

            body = metrics.render_prometheus() + obs.render_prometheus(self.cache)
            self._respond(body.encode(), "text/plain; version=0.0.4")
        elif self.path.startswith("/healthz"):
            self._respond(b"ok", "text/plain")
        elif self.path.startswith("/debug/cycles"):
            # The flight-recorder ring as JSON: the last
            # SCHEDULER_TORCH_OBS_RING cycles with phase splits, note
            # channels and bind/event counts.
            from scheduler_tpu_torch.utils import obs

            body = json.dumps({
                "enabled": obs.enabled(),
                "capacity": obs.ring_capacity(),
                "cycles": obs.ring_snapshot(),
            })
            self._respond(body.encode(), "application/json")
        elif self.path.startswith("/debug/trace"):
            # Span-tracer status: configuration, files written, last export
            # (utils/trace.py; load the cycle*.trace.json files in Perfetto).
            from scheduler_tpu_torch.utils import trace

            self._respond(
                json.dumps(trace.status()).encode(), "application/json"
            )
        elif self.path.startswith("/debug/threads"):
            # pprof stand-in (main.go:24-25): dump every thread's stack.
            frames = sys._current_frames()
            parts = []
            for tid, frame in frames.items():
                parts.append(f"--- thread {tid} ---\n")
                parts.extend(traceback.format_stack(frame))
            self._respond("".join(parts).encode(), "text/plain")
        elif self.path.startswith("/api/queues") and self.cache is not None:
            # Queue list for the kubectl-style CLI (pkg/cli/queue/list.go).
            with self.cache.mutex:
                rows = [
                    {
                        "name": q.name,
                        "weight": q.weight,
                        "jobs": sum(
                            1 for j in self.cache.jobs.values() if j.queue == q.uid
                        ),
                    }
                    for q in self.cache.queues.values()
                ]
            self._respond(json.dumps(rows).encode(), "application/json")
        else:
            self._respond(b"not found", "text/plain", 404)

    def do_POST(self) -> None:  # noqa: N802
        if self.path.startswith("/api/queues") and self.cache is not None:
            # Queue create (pkg/cli/queue/create.go:46-68: name + weight).
            length = int(self.headers.get("Content-Length", 0))
            try:
                spec = json.loads(self.rfile.read(length) or b"{}")
                queue = Queue(
                    name=spec["name"],
                    weight=int(spec.get("weight", 1)),
                    capability=spec.get("capability", {}),
                )
            except (ValueError, KeyError) as exc:
                self._respond(f"bad queue spec: {exc}".encode(), "text/plain", 400)
                return
            self.cache.add_queue(queue)
            self._respond(json.dumps({"name": queue.name}).encode(), "application/json", 201)
        else:
            self._respond(b"not found", "text/plain", 404)

    def log_message(self, fmt: str, *args) -> None:  # quiet access log
        logger.debug("http: " + fmt, *args)


def serve_metrics(
    listen_address: str, cache: Optional[SchedulerCache] = None
) -> ThreadingHTTPServer:
    """Start the /metrics (+ admin API) endpoint in a daemon thread
    (server.go:96-99).  Port 0 binds a free port: read it back from
    ``server.server_address``."""
    host, _, port = listen_address.rpartition(":")
    handler = type("BoundMetricsHandler", (_MetricsHandler,), {"cache": cache})
    server = ThreadingHTTPServer((host or "0.0.0.0", int(port)), handler)
    threading.Thread(target=server.serve_forever, name="metrics-http", daemon=True).start()
    return server


def load_cluster_state(cache: SchedulerCache, path: str) -> None:
    """Preload cluster state from a JSON file: {queues, nodes, podGroups, pods}
    — the same object schema the API-server connector speaks (connector/wire)."""
    from scheduler_tpu_torch.connector.wire import (
        parse_node,
        parse_pod,
        parse_pod_group,
        parse_queue,
    )

    with open(path, "r") as f:
        state = json.load(f)
    for q in state.get("queues", []):
        cache.add_queue(parse_queue(q))
    for n in state.get("nodes", []):
        cache.add_node(parse_node(n))
    for g in state.get("podGroups", []):
        cache.add_pod_group(parse_pod_group(g))
    for p in state.get("pods", []):
        cache.add_pod(parse_pod(p, cache.scheduler_name))


def run(opt: ServerOption, stop: Optional[threading.Event] = None,
        cluster_state: Optional[str] = None,
        synthetic: Optional[str] = None,
        api_server: Optional[str] = None) -> None:
    """app.Run equivalent (server.go:76-153).  The device resolves first: with
    no GPU and no ``device="cpu"`` this raises before anything starts."""
    from scheduler_tpu_torch.ops.device import resolve_device
    from scheduler_tpu_torch.scheduler import Scheduler

    register_options(opt)
    if opt.mesh:
        # The fused engine reads the mesh through SCHEDULER_TORCH_MESH
        # (ops/mesh.py); set unconditionally so --mesh 1 also overrides an
        # inherited environment value.
        os.environ["SCHEDULER_TORCH_MESH"] = opt.mesh
    device = resolve_device(opt.device)

    connector = None
    if api_server:
        # External system of record: list+watch ingestion + RPC side effects
        # over the wire (the reference's API-server seam, cache.go:256-336).
        from scheduler_tpu_torch.connector import connect_cache

        cache, connector = connect_cache(
            api_server,
            scheduler_name=opt.scheduler_name,
            default_queue=opt.default_queue,
            io_workers=opt.io_workers,
            dialect=opt.api_dialect or "k8s",
            # Inbound protocol: journal or per-resource k8s LIST+WATCH;
            # None defers to SCHEDULER_TORCH_WIRE.
            wire=opt.wire,
        )
    elif synthetic:
        from scheduler_tpu_torch.harness import make_synthetic_cluster

        n_nodes, n_pods = (int(x) for x in synthetic.split(","))
        cache = make_synthetic_cluster(n_nodes, n_pods).cache
    else:
        cache = SchedulerCache(
            scheduler_name=opt.scheduler_name,
            default_queue=opt.default_queue,
            io_workers=opt.io_workers,
        )
        if cluster_state:
            load_cluster_state(cache, cluster_state)

    server = serve_metrics(opt.listen_address, cache)
    stop = stop or threading.Event()
    try:
        sched = Scheduler(cache, opt.scheduler_conf, opt.schedule_period,
                          profile_dir=opt.profile_dir, device=device)

        def lead(stop_event: threading.Event) -> None:
            if connector is not None:
                connector.start()  # LIST (retried) seeds the cache, then watch
                # The first cycle must see the whole LIST.
                if not connector.wait_for_cache_sync(timeout=60):
                    logger.warning("cache sync timed out; scheduling on partial state")
            sched.run(stop_event)

        if opt.enable_leader_election:
            if api_server:
                # The lock lives in the system of record (the reference's
                # ConfigMap resource lock, server.go:111-152): a
                # coordination.k8s.io Lease CAS'd on resourceVersion.  The
                # file lease only provides HA between schedulers sharing a
                # disk.
                from scheduler_tpu_torch.utils.leaderelection import ApiLeaseLock

                elector = LeaderElector(
                    lock=lambda ident: ApiLeaseLock(api_server, identity=ident)
                )
            else:
                elector = LeaderElector(opt.lock_file)
            elector.run(lead, stop)
        else:
            lead(stop)
    finally:
        # Drain the bind/evict IO against the live server first, then stop
        # ingestion and the endpoint.
        cache.stop()
        if connector is not None:
            connector.stop()
        server.shutdown()
        server.server_close()


def main(argv: Optional[List[str]] = None) -> None:
    """Parse the daemon's flags and run it until SIGINT or SIGTERM.  Installs
    the signal handlers, so it must run in the main thread."""
    import argparse

    from scheduler_tpu_torch.options import add_flags

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    parser = argparse.ArgumentParser(
        prog="scheduler_tpu_torch", description="GPU batch scheduler daemon"
    )
    add_flags(parser)
    parser.add_argument(
        "--cluster-state", default=None,
        help="JSON file with initial cluster state (queues/nodes/podGroups/pods)",
    )
    parser.add_argument(
        "--synthetic", default=None, metavar="NODES,PODS",
        help="generate a synthetic cluster instead of loading state",
    )
    parser.add_argument(
        "--api-server", default=None, metavar="URL",
        help="external system of record (list+watch in, binds/evictions out)",
    )
    parser.add_argument(
        "--api-dialect", default="k8s", choices=("k8s", "legacy"),
        help="outbound wire shapes: real Kubernetes API calls (default) or "
             "the compact legacy JSON RPCs",
    )
    parser.add_argument(
        "--wire", default=None, choices=("journal", "k8s"),
        help="inbound ingestion protocol: the bespoke state/watch journal "
             "or Kubernetes-conformant per-resource LIST+WATCH reflectors; "
             "unset defers to SCHEDULER_TORCH_WIRE (default k8s)",
    )
    ns = parser.parse_args(argv)
    if getattr(ns, "version", False):
        from scheduler_tpu_torch.version import version_string

        print(version_string())
        return
    opt = option_from_namespace(ns)

    stop = threading.Event()

    def on_signal(signum, frame) -> None:
        logger.info("signal %s: shutting down", signum)
        stop.set()

    previous = {sig: signal.signal(sig, on_signal)
                for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        run(opt, stop, cluster_state=ns.cluster_state, synthetic=ns.synthetic,
            api_server=ns.api_server)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    main()
