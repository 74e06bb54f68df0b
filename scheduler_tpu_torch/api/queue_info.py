"""Queue info (reference ``pkg/scheduler/api/queue_info.go``)."""

from __future__ import annotations

from scheduler_tpu_torch.apis.objects import Queue


class QueueInfo:
    __slots__ = ("uid", "name", "weight", "queue")

    def __init__(self, queue: Queue) -> None:
        self.uid: str = queue.name  # reference uses the name as QueueID
        self.name: str = queue.name
        self.weight: int = queue.weight
        self.queue: Queue = queue

    @property
    def creation_timestamp(self) -> float:
        return self.queue.creation_timestamp

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def __repr__(self) -> str:
        return f"Queue({self.name} weight={self.weight})"
