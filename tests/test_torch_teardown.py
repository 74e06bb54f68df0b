"""A dropped cluster, and a job deleted from a live cache, are freed.

A job's task rows hold its tasks in a numpy object array, and each task
bound to the rows refers back to them; the cycle collector does not walk
object arrays, so the job's teardown (``_TaskRows.release``) breaks that
cycle.  Each test holds weak references to one task and its job, drops
the last strong ones, runs ``gc.collect()`` and expects both dead.
"""

import gc
import weakref

import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from scheduler_tpu_torch.api.job_info import TaskInfo
from scheduler_tpu_torch.harness import make_synthetic_cluster
from scheduler_tpu_torch.scheduler import Scheduler

CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: drf
  - name: proportion
  - name: binpack
"""


def _cluster():
    """Two queues of 8-pod gangs on a cluster that holds about half of
    them: some gangs bind, the others stay pending."""
    return make_synthetic_cluster(2, 240, tasks_per_job=8, queues=("q0", "q1"),
                                  queue_weights={"q0": 1, "q1": 2}).cache


def _run_cycle(cache, tmp_path):
    conf = tmp_path / "conf.yaml"
    conf.write_text(CONF)
    Scheduler(cache, scheduler_conf=str(conf), device="cpu").run_once()
    assert cache.binder.binds, "the cycle bound nothing"


def _live_tasks() -> int:
    return sum(1 for o in gc.get_objects() if type(o) is TaskInfo)


def test_dropped_cluster_is_freed(tmp_path):
    gc.collect()
    before = _live_tasks()
    cache = _cluster()
    _run_cycle(cache, tmp_path)
    job = next(iter(cache.jobs.values()))
    task = job.store.cores[0]
    refs = (weakref.ref(job), weakref.ref(task))
    assert _live_tasks() >= before + 240
    del job, task, cache
    gc.collect()
    assert [r() for r in refs] == [None, None]
    assert _live_tasks() == before, "some task of the dropped cluster is still alive"


def test_deleted_job_is_freed_from_a_live_cache(tmp_path):
    """A pending job whose pods and PodGroup are deleted after a cycle (the
    cycle's snapshot bound views of its tasks to the clone's rows)."""
    cache = _cluster()
    _run_cycle(cache, tmp_path)
    # The fake status updater's journal keeps the cycle's job clones (which
    # share the job's task array): the test's record, not the scheduler's.
    cache.status_updater.pod_group_updates.clear()
    job = next(j for j in cache.jobs.values() if not j.allocated.array.any())
    uid, pg = job.uid, job.pod_group
    pods = [t.pod for t in job.tasks.values()]
    task = job.store.cores[0]
    refs = (weakref.ref(job), weakref.ref(task))
    del job, task
    for pod in pods:
        cache.delete_pod(pod)
    cache.delete_pod_group(pg)
    del pods
    assert uid not in cache.jobs
    gc.collect()
    assert [r() for r in refs] == [None, None]
    assert len(cache.jobs) == 29, "the other jobs stay"
