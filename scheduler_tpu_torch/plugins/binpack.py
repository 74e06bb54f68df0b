"""Binpack plugin: pack nodes tight (MostRequested-style scoring).

Not in the reference snapshot (Volcano grew it later), but required by the
benchmark ladder ("binpack + drf", BASELINE.md config #3): scoring that favors
fuller nodes leaves large holes for gangs and big jobs.  Weighted by
``binpack.weight`` (default 1).
"""

from __future__ import annotations

from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.interface import Plugin
from scheduler_tpu_torch.plugins.util import binpack_host

BINPACK_WEIGHT = "binpack.weight"


class BinpackPlugin(Plugin):
    def __init__(self, arguments: Arguments) -> None:
        self.arguments = arguments
        self.weight = arguments.get_float(BINPACK_WEIGHT, 1.0)

    def name(self) -> str:
        return "binpack"

    def on_session_open(self, ssn) -> None:
        w = self.weight

        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            return w * binpack_host(task, node) if w else 0.0

        ssn.add_node_order_fn(self.name(), node_order_fn)
        ssn.device_score_weights["binpack"] = ssn.device_score_weights.get("binpack", 0.0) + w
        ssn.device_weighted_plugins.add(self.name())


def new(arguments: Arguments) -> BinpackPlugin:
    return BinpackPlugin(arguments)
