"""ClusterInfo: the frozen snapshot triple a Session schedules against
(reference ``pkg/scheduler/api/cluster_info.go``)."""

from __future__ import annotations

from typing import Dict

from scheduler_tpu_torch.api.job_info import JobInfo
from scheduler_tpu_torch.api.node_info import NodeInfo
from scheduler_tpu_torch.api.queue_info import QueueInfo
from scheduler_tpu_torch.api.vocab import ResourceVocabulary


class ClusterInfo:
    __slots__ = ("jobs", "nodes", "queues", "vocab", "node_generation", "dirty_epoch")

    def __init__(self, vocab: ResourceVocabulary) -> None:
        self.vocab = vocab
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        # The owning cache's node-spec generation AT SNAPSHOT TIME (under the
        # cache mutex) — consumers keying caches on it must never read the
        # live counter, which can advance between snapshot and use.
        self.node_generation: int = -1
        # The cache's dirty-set epoch at snapshot time (-1: unknown).
        self.dirty_epoch: int = -1

    def __repr__(self) -> str:
        return (
            f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
            f"queues={len(self.queues)})"
        )
