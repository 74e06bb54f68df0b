"""Synthetic cluster generator — the kubemark analogue (SURVEY.md §7.2.8).

The reference's perf rig boots hollow nodes on a kubemark master and floods it
with density/latency jobs (``test/kubemark/start-kubemark.sh``,
``test/e2e/benchmark.go:53-285``).  Here a "hollow node" is a row in the node
tensors: this module mass-produces nodes, queues, and gang PodGroups straight
into a ``SchedulerCache`` so the BASELINE.json scenario ladder can run without
any cluster.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from scheduler_tpu_torch.api.vocab import ResourceVocabulary
from scheduler_tpu_torch.apis.objects import (
    GROUP_NAME_ANNOTATION,
    NodeSpec,
    PodGroup,
    PodSpec,
    Queue,
)
from scheduler_tpu_torch.cache.cache import SchedulerCache

MIB = 1024.0 * 1024.0
GIB = 1024.0 * MIB


@dataclass
class SyntheticCluster:
    cache: SchedulerCache
    n_nodes: int
    n_pods: int
    vocab: ResourceVocabulary
    pod_names: List[str] = field(default_factory=list)


def mixed_request(i: int, gpu: bool) -> Dict[str, float]:
    """Deterministic mixed CPU/mem(/GPU) requests (BASELINE config #3)."""
    cpu_m = [250.0, 500.0, 1000.0, 2000.0][i % 4]
    mem = [256.0, 512.0, 1024.0, 2048.0][(i // 4) % 4] * MIB
    req = {"cpu": cpu_m, "memory": mem}
    if gpu and i % 8 == 0:
        req["nvidia.com/gpu"] = 1.0
    return req


def make_synthetic_cluster(
    n_nodes: int,
    n_pods: int,
    tasks_per_job: int = 100,
    queues: Sequence[str] = ("default",),
    queue_weights: Optional[Dict[str, int]] = None,
    node_cpu_milli: float = 64_000.0,
    node_memory: float = 256.0 * GIB,
    node_gpus: int = 0,
    node_labels_fn=None,
    gang: bool = True,
    vocab: Optional[ResourceVocabulary] = None,
    request_offset: int = 0,
    request_fn=None,
    node_extra: Optional[Dict[str, float]] = None,
) -> SyntheticCluster:
    """Build a cache holding n_nodes hollow nodes and n_pods pending gang pods.

    ``request_offset`` rotates the deterministic request/priority pattern so
    same-SHAPE clusters can carry distinct workloads — the multi-tenant rig
    (harness/tenant.py) builds K such clusters whose ledger tensors stack
    lane-for-lane while each lane's content stays its own.

    ``request_fn(job_idx, task_idx)`` overrides the mixed-request pattern
    with a caller-shaped request dict — the MQ bench uses it to make every
    queue's pods request ONE uniform vector, the shape the qfair class
    ladder admits (docs/QUEUE_DELTA.md "Class-ladder solve").  ``node_extra``
    adds extra allocatable resources to every hollow node (the wide-vocab
    scalars those requests name)."""
    if vocab is None:
        vocab = ResourceVocabulary(("nvidia.com/gpu",) if node_gpus else ())
    cache = SchedulerCache(vocab=vocab, async_io=False)
    cache.run()

    weights = queue_weights or {}
    for q in queues:
        cache.add_queue(Queue(name=q, weight=weights.get(q, 1)))

    for i in range(n_nodes):
        allocatable = {
            "cpu": node_cpu_milli,
            "memory": node_memory,
            "pods": 110,
        }
        if node_gpus:
            allocatable["nvidia.com/gpu"] = float(node_gpus)
        if node_extra:
            allocatable.update(node_extra)
        labels = node_labels_fn(i) if node_labels_fn else {}
        cache.add_node(NodeSpec(name=f"hn-{i:06d}", allocatable=allocatable, labels=labels))

    pod_names: List[str] = []
    n_jobs = max(1, (n_pods + tasks_per_job - 1) // tasks_per_job)
    pod_idx = 0
    # Deterministic creation timestamps (one shared base second + µs offsets):
    # engine-parity comparisons across separately built synthetic clusters
    # must not depend on wall-clock second boundaries (the job tie key
    # truncates to whole seconds, matching metav1.Time granularity).
    ts_base = 1_700_000_000.0
    for j in range(n_jobs):
        size = min(tasks_per_job, n_pods - j * tasks_per_job)
        if size <= 0:
            break
        queue = queues[j % len(queues)]
        group = f"job-{j:05d}"
        pg = PodGroup(
            name=group,
            namespace="default",
            queue=queue,
            min_member=size if gang else 1,
        )
        pg.status.phase = "Inqueue"
        pg.creation_timestamp = ts_base + j * 1e-6
        cache.add_pod_group(pg)
        for t in range(size):
            name = f"{group}-{t:04d}"
            pod = PodSpec(
                name=name,
                namespace="default",
                containers=[
                    request_fn(j, t) if request_fn is not None
                    else mixed_request(request_offset + pod_idx, node_gpus > 0)
                ],
                phase="Pending",
                priority=(j + request_offset) % 10,
                annotations={GROUP_NAME_ANNOTATION: group},
            )
            pod.creation_timestamp = ts_base + pod_idx * 1e-6
            cache.add_pod(pod)
            pod_names.append(f"default/{name}")
            pod_idx += 1

    return SyntheticCluster(
        cache=cache, n_nodes=n_nodes, n_pods=pod_idx, vocab=vocab, pod_names=pod_names
    )
