"""Cluster-state cache: the rebuildable mirror the scheduler snapshots from
(reference ``pkg/scheduler/cache``)."""

from scheduler_tpu_torch.cache.interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder
from scheduler_tpu_torch.cache.fakes import FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder
from scheduler_tpu_torch.cache.cache import SchedulerCache

__all__ = [
    "Binder",
    "Cache",
    "Evictor",
    "StatusUpdater",
    "VolumeBinder",
    "FakeBinder",
    "FakeEvictor",
    "FakeStatusUpdater",
    "FakeVolumeBinder",
    "SchedulerCache",
]
