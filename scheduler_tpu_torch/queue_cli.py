"""kubectl-style queue CLI: ``python -m scheduler_tpu_torch.queue_cli``.

Reference: ``cmd/cli/queue.go:26-52`` + ``pkg/cli/queue/{create,list}.go`` —
``queue create --name N --weight W`` and ``queue list``, issued against the
running scheduler daemon's admin API (the API-server stand-in; see
``cli.serve_metrics``).
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import List, Optional

DEFAULT_SERVER = "http://127.0.0.1:8080"


def queue_create(server: str, name: str, weight: int) -> dict:
    req = urllib.request.Request(
        f"{server}/api/queues",
        data=json.dumps({"name": name, "weight": weight}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def queue_list(server: str) -> List[dict]:
    with urllib.request.urlopen(f"{server}/api/queues", timeout=10) as resp:
        return json.loads(resp.read())


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="scheduler_tpu_torch queue", description="Queue CRUD")
    parser.add_argument("--server", default=DEFAULT_SERVER,
                        help="scheduler daemon admin endpoint")
    sub = parser.add_subparsers(dest="command", required=True)

    create = sub.add_parser("create", help="create a weighted queue")
    create.add_argument("--name", required=True)
    create.add_argument("--weight", type=int, default=1)

    sub.add_parser("list", help="list queues with job counts")

    ns = parser.parse_args(argv)
    if ns.command == "create":
        out = queue_create(ns.server, ns.name, ns.weight)
        print(f"created queue {out['name']}")
    else:
        rows = queue_list(ns.server)
        print(f"{'Name':<20}{'Weight':>8}{'Jobs':>8}")
        for row in rows:
            print(f"{row['name']:<20}{row['weight']:>8}{row['jobs']:>8}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
