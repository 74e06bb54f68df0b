"""CLI flags for the scheduler daemon.

Reference: ``cmd/kube-batch/app/options/options.go`` — same knobs, same
defaults (scheduler-name ``volcano`` :27, schedule-period 1s :28, default-queue
``default`` :29, listen address ``:8080`` :31, leader election + lock namespace
:40-50).  The kube API QPS/burst flags become the cache's io-worker knob — the
binding backend here is the cache's async executor, not a rate-limited REST
client.

The JAX package's flags (``scheduler_tpu/options.py``) with one more:
``--device`` (default: CUDA; ``cpu`` runs the plain PyTorch versions, for
tests).  ``--mesh`` takes the JAX package's specs (``1``, ``N``, ``auto``,
``RxC``) over the process's CUDA devices (``ops/mesh.py``).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional

DEFAULT_SCHEDULER_NAME = "volcano"
DEFAULT_SCHEDULER_PERIOD = 1.0
DEFAULT_QUEUE = "default"
DEFAULT_LISTEN_ADDRESS = ":8080"
DEFAULT_LOCK_FILE = "/tmp/scheduler_tpu-leader.lock"  # the JAX daemon's: one lease


@dataclass
class ServerOption:
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    scheduler_conf: Optional[str] = None
    schedule_period: float = DEFAULT_SCHEDULER_PERIOD
    default_queue: str = DEFAULT_QUEUE
    listen_address: str = DEFAULT_LISTEN_ADDRESS
    enable_leader_election: bool = False
    lock_file: str = DEFAULT_LOCK_FILE
    enable_priority_class: bool = True
    io_workers: int = 8
    # torch.profiler trace dir; traces of the first cycles when set (the
    # pprof analogue, main.go:24-25).
    profile_dir: Optional[str] = None
    # Device mesh for the fused engine's node axis: "1" one device (default),
    # "N"/"auto" a 1-D mesh, "RxC" a 2-D (replica, nodes) mesh (ops/mesh.py).
    mesh: str = "1"
    # Outbound wire dialect for --api-server: "k8s" (real Kubernetes API
    # shapes — pods/binding POSTs, pod DELETEs, status PATCHes) or "legacy"
    # (the compact bespoke JSON RPCs).
    api_dialect: str = "k8s"
    # Inbound ingestion protocol for --api-server: "journal" (the bespoke
    # GET /state + GET /watch?since=seq journal) or "k8s" (per-resource
    # LIST+WATCH reflectors with resourceVersion cursors and 410 Gone
    # relist recovery — docs/INGEST.md).  None defers to SCHEDULER_TORCH_WIRE
    # (default k8s).
    wire: Optional[str] = None
    # Where the cycles run: None = CUDA (raises without a GPU); "cpu" runs
    # the plain PyTorch versions of the kernels (tests).
    device: Optional[str] = None


# The reference keeps a mutable global the cache reads back
# (options.go:54 ServerOpts); preserved for the same wiring.
ServerOpts: ServerOption = ServerOption()


def register_options(opt: ServerOption) -> None:
    global ServerOpts
    ServerOpts = opt


def add_flags(parser: argparse.ArgumentParser) -> None:
    """options.go:63-81 equivalents."""
    parser.add_argument(
        "--scheduler-name", default=DEFAULT_SCHEDULER_NAME,
        help="pods with this schedulerName are scheduled by this scheduler",
    )
    parser.add_argument(
        "--scheduler-conf", default=None,
        help="path to the YAML scheduler configuration (actions + plugin tiers)",
    )
    parser.add_argument(
        "--schedule-period", default=DEFAULT_SCHEDULER_PERIOD, type=float,
        help="seconds between scheduling cycles",
    )
    parser.add_argument(
        "--default-queue", default=DEFAULT_QUEUE,
        help="queue assigned to pod groups whose queue is unset",
    )
    parser.add_argument(
        "--listen-address", default=DEFAULT_LISTEN_ADDRESS,
        help="host:port for the /metrics + /healthz HTTP endpoint",
    )
    parser.add_argument(
        "--leader-elect", action="store_true", default=False,
        help="run active/standby with a lease lock; only the leader schedules",
    )
    parser.add_argument(
        "--lock-file", default=DEFAULT_LOCK_FILE,
        help="lease-lock path used for leader election",
    )
    parser.add_argument(
        "--io-workers", default=8, type=int,
        help="async bind/evict executor workers (the QPS/burst analogue)",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write torch.profiler traces of the first cycles to this directory",
    )
    parser.add_argument(
        "--mesh", default="1",
        help="node-axis device mesh for the fused engine: 1 (one device), "
             "N or auto (1-D over the first power-of-two devices) or RxC "
             "(2-D replica x nodes, powers of two)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device the cycles run on: unset = cuda (fails without a "
             "GPU); cpu runs the kernels' plain PyTorch versions (tests)",
    )
    parser.add_argument(
        "--version", action="store_true", default=False,
        help="print version/build info and exit (pkg/version/version.go:26-33)",
    )


def option_from_namespace(ns: argparse.Namespace) -> ServerOption:
    """Map an ``add_flags`` namespace to a ServerOption (single source of truth
    for the flag wiring — cli.main reuses this)."""
    return ServerOption(
        scheduler_name=ns.scheduler_name,
        scheduler_conf=ns.scheduler_conf,
        schedule_period=ns.schedule_period,
        default_queue=ns.default_queue,
        listen_address=ns.listen_address,
        enable_leader_election=ns.leader_elect,
        lock_file=ns.lock_file,
        io_workers=ns.io_workers,
        profile_dir=ns.profile_dir,
        mesh=ns.mesh,
        api_dialect=getattr(ns, "api_dialect", "k8s"),
        wire=getattr(ns, "wire", None),
        device=getattr(ns, "device", None),
    )
