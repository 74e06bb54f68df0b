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


def make_mq_ladder_cluster(n_nodes: int, n_pods: int, n_queues: int,
                           vocab_w: int) -> SyntheticCluster:
    """The qfair class ladder's shape, ``bench.py``'s multi-queue family
    (``one_mq_cycle``): queues q0, q1, ... of weights 1, 2, ...; ``n_pods``
    single-pod jobs, job j in queue j % n_queues, each pod of queue q asking
    250 (q + 1) m cpu, 256 (q + 1) MiB and one unit of the scalar
    ``bench.widevocab/r{q % vocab_w}`` (one request class a queue); nodes of
    64 cpu, 256 GiB and 110 pods, plus ``n_pods`` units of each of the
    ``vocab_w`` scalars.  Timestamps are fixed (``make_synthetic_cluster``),
    so every build orders its jobs alike."""
    queues = tuple(f"q{i}" for i in range(n_queues))
    wide = tuple(f"bench.widevocab/r{i}" for i in range(vocab_w))

    def uniform_request(j: int, t: int) -> Dict[str, float]:
        qi = j % n_queues  # make_synthetic_cluster deals job j to queue j % Q
        req = {"cpu": 250.0 * (qi + 1), "memory": 256.0 * (qi + 1) * MIB}
        if wide:
            req[wide[qi % len(wide)]] = 1.0
        return req

    return make_synthetic_cluster(
        n_nodes, n_pods, tasks_per_job=1, queues=queues,
        queue_weights={q: i + 1 for i, q in enumerate(queues)},
        vocab=ResourceVocabulary(wide), request_fn=uniform_request,
        node_extra={name: float(n_pods) for name in wide},
    )


def job_template_request(n_jobs: int, seed: int = 0):
    """Per-job request templates: job j takes cell c_j of a 64 x 128 grid,
    drawn without replacement by ``numpy.random.default_rng(seed).choice(8192,
    n_jobs, replace=False)``; every pod of the job asks cpu 125m * (1 + c %
    64) (125m-8 cpu) and memory 256 MiB * (1 + c // 64) (256 MiB-32 GiB).
    Returns ``request(j, t)`` for ``make_synthetic_cluster(request_fn=)``:
    with more than 4,096 gangs, more than 4,096 request signatures close the
    mega kernel's gate (``chip_smoke.template_cluster``)."""
    import numpy as np

    cells = np.random.default_rng(seed).choice(8192, n_jobs, replace=False)

    def request(j: int, t: int) -> Dict[str, float]:
        del t
        c = int(cells[j])
        return {"cpu": 125.0 * (1 + c % 64), "memory": 256.0 * MIB * (1 + c // 64)}

    return request


KUBEMARK_TS0 = 1_700_000_000.0


def pin_shadow_timestamps(cache) -> None:
    """Give every shadow PodGroup its pod's creation time.  The cache stamps
    a shadow PodGroup with the wall clock when it adopts a bare pod, and the
    session's job order breaks ties on the whole second of that stamp, so
    two clusters built from the same pods would order their jobs apart
    whenever one build straddles a second boundary."""
    for job in cache.jobs.values():
        pg = job.pod_group
        if pg is None or not pg.shadow:
            continue
        ts = min(task.pod.creation_timestamp for task in job.tasks.values())
        pg.creation_timestamp = ts
        job.creation_timestamp = ts


def make_kubemark_density_cluster(n_nodes: int, n_pods: int, seed: int = 0) -> SyntheticCluster:
    """BASELINE config 2, the kubemark density scenario
    (``scripts/scenario_ladder.py`` scenario 2; full size 1,000 nodes x 5,000
    pods): hollow nodes labelled ``zone=z{i % 4}`` with 16 cpu, 64 GiB and
    110 pods each, and BARE sleep pods (no PodGroup: the cache makes a
    shadow single-member PodGroup for each) in one queue.  Every even pod
    selects its zone ``z{idx % 4}``; requests are cpu {100, 200, 500}m and
    memory {1, 2} GiB, drawn from ``numpy.random.default_rng(seed)``.  Each
    shadow PodGroup takes its pod's creation time (``pin_shadow_timestamps``),
    so that every build of the same arguments orders its jobs alike."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = ResourceVocabulary()
    cache = SchedulerCache(vocab=vocab, async_io=False)
    cache.run()
    cache.add_queue(Queue(name="default", weight=1))
    for i in range(n_nodes):
        cache.add_node(NodeSpec(name=f"hollow-{i:05d}", allocatable={
            "cpu": 16000.0, "memory": 64 * GIB, "pods": 110},
            labels={"zone": f"z{i % 4}"}))
    pod_names: List[str] = []
    for t in range(n_pods):
        name = f"sleep-{t:05d}"
        pod = PodSpec(
            name=name, namespace="d", scheduler_name="volcano",
            containers=[{"cpu": float(rng.choice([100, 200, 500])),
                         "memory": float(rng.choice([1, 2])) * 2**30}],
            node_selector={"zone": f"z{t % 4}"} if t % 2 == 0 else {})
        pod.creation_timestamp = KUBEMARK_TS0 + t * 1e-6
        cache.add_pod(pod)
        pod_names.append(f"d/{name}")
    pin_shadow_timestamps(cache)
    return SyntheticCluster(
        cache=cache, n_nodes=n_nodes, n_pods=n_pods, vocab=vocab, pod_names=pod_names
    )


def kubemark_density_documents(n_nodes: int, n_pods: int, seed: int = 0) -> Dict[str, list]:
    """``make_kubemark_density_cluster``'s cluster as ``kubectl``-shaped API
    documents (``{"queues", "nodes", "podGroups", "pods"}``, the schema of
    ``cli.load_cluster_state``), for a mock API server: the same nodes,
    bare pods, requests (the same draws from the seed), selectors and pod
    creation times.  The shadow PodGroups are the cache's to make."""
    import datetime

    import numpy as np

    def stamp(ts: float) -> str:
        return datetime.datetime.fromtimestamp(ts, datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%fZ")

    rng = np.random.default_rng(seed)
    queues = [{"apiVersion": "scheduling.incubator.k8s.io/v1alpha1", "kind": "Queue",
               "metadata": {"name": "default"}, "spec": {"weight": 1}}]
    nodes = [{"apiVersion": "v1", "kind": "Node",
              "metadata": {"name": f"hollow-{i:05d}", "labels": {"zone": f"z{i % 4}"}},
              "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": "110"}}}
             for i in range(n_nodes)]
    pods = []
    for t in range(n_pods):
        cpu = int(rng.choice([100, 200, 500]))
        mem = int(rng.choice([1, 2]))
        spec = {"schedulerName": "volcano", "containers": [
            {"name": "sleep", "resources": {"requests": {"cpu": f"{cpu}m",
                                                         "memory": f"{mem}Gi"}}}]}
        if t % 2 == 0:
            spec["nodeSelector"] = {"zone": f"z{t % 4}"}
        pods.append({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"sleep-{t:05d}", "namespace": "d",
                                  "creationTimestamp": stamp(KUBEMARK_TS0 + t * 1e-6)},
                     "spec": spec, "status": {"phase": "Pending"}})
    return {"queues": queues, "nodes": nodes, "podGroups": [], "pods": pods}


GPU = "nvidia.com/gpu"


def make_gpu_topology_cluster(n_nodes: int, n_gangs: int, gang: int = 8) -> SyntheticCluster:
    """BASELINE config 5, GPU topology gangs (``scripts/scenario_ladder.py``
    scenario 5, its cluster build without the churn; full size 1,500 nodes x
    1,000 gangs of 8): nodes of 64 cpu, 256 GiB, 8 GPUs and 110 pods,
    labelled ``zone=z{i % 8}``, and gang PodGroups (minMember ``gang``) whose
    pods each ask 4 cpu, 16 GiB and one GPU and select the zone
    ``z{j % 8}`` of their gang j.  Timestamps are fixed, so every build
    orders its jobs alike."""
    vocab = ResourceVocabulary((GPU,))
    cache = SchedulerCache(vocab=vocab, async_io=False)
    cache.run()
    cache.add_queue(Queue(name="default", weight=1))
    for i in range(n_nodes):
        cache.add_node(NodeSpec(
            name=f"gpu-{i:04d}",
            allocatable={"cpu": 64000.0, "memory": 256 * GIB, GPU: 8.0, "pods": 110},
            labels={"zone": f"z{i % 8}"}))
    pod_names: List[str] = []
    for j in range(n_gangs):
        group = f"train{j}"
        pg = PodGroup(name=group, namespace="d", queue="default", min_member=gang)
        pg.status.phase = "Inqueue"
        pg.creation_timestamp = KUBEMARK_TS0 + j
        cache.add_pod_group(pg)
        for t in range(gang):
            pod = PodSpec(
                name=f"{group}-{t}", namespace="d",
                containers=[{"cpu": 4000.0, "memory": 16 * GIB, GPU: 1.0}],
                annotations={GROUP_NAME_ANNOTATION: group},
                node_selector={"zone": f"z{j % 8}"})
            pod.creation_timestamp = KUBEMARK_TS0 + j + t * 1e-6
            cache.add_pod(pod)
            pod_names.append(f"d/{group}-{t}")
    return SyntheticCluster(
        cache=cache, n_nodes=n_nodes, n_pods=n_gangs * gang, vocab=vocab, pod_names=pod_names
    )


def aftermath_thin_requests(n_pend: int, n_distinct: int, seed: int = 0) -> List[Dict[str, float]]:
    """The pending ``thin`` pods' requests of ``make_reclaim_aftermath_cluster``
    with ``thin_requests``: ``n_distinct`` distinct (cpu, memory) pairs drawn
    without replacement by ``numpy.random.default_rng(seed)`` from the grid
    cpu 100m * a (a = 1..20) x memory 16 MiB * b (b = 1..256), each at most
    the ``fat`` pod's 2 cpu / 4 GiB, so every ``thin`` pod still fits one
    slot of idle or releasing capacity; then dealt pod by pod, each pair to
    ``n_pend / n_distinct`` pods (rounded up) in a seeded shuffle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cells = rng.choice(20 * 256, n_distinct, replace=False)
    order = rng.permutation(np.resize(np.arange(n_distinct), n_pend))
    return [{"cpu": 100.0 * (1 + int(cells[k]) % 20), "memory": 16 * MIB * (1 + int(cells[k]) // 20)}
            for k in order.tolist()]


def make_reclaim_cluster(scale: float = 1.0, thin_requests: int = 0,
                         seed: int = 0) -> SyntheticCluster:
    """BASELINE config 4's cluster before its reclaim (two queues,
    proportion, reclaim; ``scripts/scenario_ladder.py`` scenario 4, its
    cluster build, ``_s4_build_churn``'s ``build``, without the churn).

    Queues ``fat`` and ``thin`` of weight 1; ``1000 * scale`` nodes of
    26 x (2 cpu, 4 GiB) and 110 pods; ``25,000 * scale`` RUNNING ``fat``
    pods of 2 cpu and 4 GiB in gangs of 50 (minMember 1), pod t of gang j on
    node (50 j + t) mod nodes, so 25 on each node at full size; ``50,000 *
    scale`` pending ``thin`` pods of the same request in gangs of 50
    (minMember 1).  ``fat`` holds 25,000 of the 26,000 slots while the 1:1
    weights deserve each queue 13,000: a reclaim takes ``fat`` down to its
    share for ``thin``.

    With ``thin_requests`` > 0 the ``thin`` pods ask that many distinct
    requests (``aftermath_thin_requests``, drawn from ``seed``).

    Timestamps are fixed, so every build orders its queues and jobs alike;
    without ``thin_requests`` the build draws no random numbers."""
    gang = 50
    n_nodes = int(1000 * scale)
    n_run = int(25_000 * scale)
    n_pend = int(50_000 * scale)
    slots = n_run // n_nodes + 1
    request = {"cpu": 2000.0, "memory": 4 * GIB}
    thin = aftermath_thin_requests(n_pend, thin_requests, seed) if thin_requests else None
    vocab = ResourceVocabulary()
    cache = SchedulerCache(vocab=vocab, async_io=False)
    cache.run()
    for k, name in enumerate(("fat", "thin")):
        queue = Queue(name=name, weight=1)
        queue.creation_timestamp = KUBEMARK_TS0 + k * 1e-6
        cache.add_queue(queue)
    for i in range(n_nodes):
        cache.add_node(NodeSpec(name=f"n{i:05d}", allocatable={
            "cpu": 2000.0 * slots, "memory": 4 * GIB * slots, "pods": 110}))
    pod_names: List[str] = []

    def add_gang(name: str, queue: str, ts: float, running: bool, first: int) -> None:
        pg = PodGroup(name=name, namespace="d", queue=queue, min_member=1)
        pg.status.phase = "Running" if running else "Inqueue"
        pg.creation_timestamp = ts
        cache.add_pod_group(pg)
        for t in range(gang):
            req = request if running or thin is None else thin[first + t]
            pod = PodSpec(
                name=f"{name}-{t}", namespace="d", containers=[dict(req)],
                annotations={GROUP_NAME_ANNOTATION: name},
                node_name=f"n{(first + t) % n_nodes:05d}" if running else "",
                phase="Running" if running else "Pending")
            pod.creation_timestamp = ts + t * 1e-6
            cache.add_pod(pod)
            pod_names.append(f"d/{name}-{t}")

    n_fat = n_run // gang
    for j in range(n_fat):
        add_gang(f"fat{j}", "fat", KUBEMARK_TS0 + 1.0 + j, True, j * gang)
    for j in range(n_pend // gang):
        add_gang(f"thin{j}", "thin", KUBEMARK_TS0 + 1.0 + n_fat + j, False, j * gang)
    return SyntheticCluster(
        cache=cache, n_nodes=n_nodes, n_pods=len(pod_names), vocab=vocab, pod_names=pod_names
    )


def make_reclaim_aftermath_cluster(scale: float = 1.0, thin_requests: int = 0,
                                   seed: int = 0) -> SyntheticCluster:
    """BASELINE config 4's cluster (``make_reclaim_cluster``) in the state
    its reclaim leaves while the victims terminate:
    ``cache.evict(task, "reclaim")`` on every pod of every odd-numbered
    ``fat`` gang, 12,500 pods at full size, spread over all nodes, whose
    resources stay RELEASING until they terminate.  That is what a reclaim
    that enforces the 1:1 shares leaves behind: the next allocate fits
    ``thin`` on each node's idle slot and pipelines the rest onto the
    releasing capacity, up to ``thin``'s deserved share.

    With ``thin_requests`` > 0 the ``thin`` pods ask that many distinct
    requests: past 4,096 signatures the mega kernel's gate closes, and the
    ``fused_allocate`` loop's releasing arm runs."""
    cluster = make_reclaim_cluster(scale, thin_requests, seed)
    cache = cluster.cache
    for j in range(1, int(25_000 * scale) // 50, 2):
        for task in list(cache.jobs[f"d/fat{j}"].tasks.values()):
            cache.evict(task, "reclaim")
    return cluster


# -- churn: the scenario ladder's steady-state workloads ----------------------------

def retire_jobs(cache, entries) -> None:
    """Delete jobs' pods and PodGroups through the cache's event handlers
    (the informer's delete path: bound pods free their nodes)."""
    for pg, pods in entries:
        for pod in pods:
            cache.delete_pod(pod)
        if pg is not None:
            cache.delete_pod_group(pg)


def config3_churn(n_nodes: int, n_pods: int, per_job: int = 100):
    """BASELINE config 3 under churn, a copy of ``scripts/scenario_ladder.py``
    ``_s3_build_churn``: ``(build, churn)``.  ``build()`` is
    ``make_synthetic_cluster(n_nodes, n_pods, tasks_per_job=per_job)``'s
    cache; ``churn(cache, rng, i)`` retires a tenth of the live gangs (drawn
    by ``rng``) and adds as many new Inqueue gangs of ``per_job`` pods with
    the flagship's request and priority pattern."""
    alive = {"jobs": [], "gen": 0}

    def add_gang(cache, g, base_idx):
        pg = PodGroup(name=g, namespace="default", queue="default", min_member=per_job)
        pg.status.phase = "Inqueue"
        pg.creation_timestamp = KUBEMARK_TS0 + base_idx * 1e-6
        cache.add_pod_group(pg)
        pods = []
        for t in range(per_job):
            i = base_idx + t
            pod = PodSpec(name=f"{g}-{t:04d}", namespace="default",
                          containers=[mixed_request(i, False)],
                          priority=(base_idx // per_job) % 10,
                          annotations={GROUP_NAME_ANNOTATION: g})
            pod.creation_timestamp = KUBEMARK_TS0 + i * 1e-6
            cache.add_pod(pod)
            pods.append(pod)
        alive["jobs"].append((pg, pods))

    def build():
        cache = make_synthetic_cluster(n_nodes, n_pods, tasks_per_job=per_job).cache
        for job in cache.jobs.values():
            alive["jobs"].append((job.pod_group, [t.pod for t in job.tasks.values()]))
        return cache

    def churn(cache, rng, i):
        del i
        k = max(1, len(alive["jobs"]) // 10)
        idx = rng.choice(len(alive["jobs"]), size=k, replace=False)
        chosen = sorted(set(idx.tolist()), reverse=True)
        retiring = [alive["jobs"][j] for j in chosen]
        for j in chosen:
            alive["jobs"][j] = alive["jobs"][-1]
            alive["jobs"].pop()
        retire_jobs(cache, retiring)
        alive["gen"] += 1
        for t in range(k):
            add_gang(cache, f"churn-{alive['gen']:03d}-{t:04d}",
                     n_pods + (alive["gen"] * k + t) * per_job)

    return build, churn


def config2_churn(n_nodes: int, n_pods: int):
    """BASELINE config 2 under churn, a copy of ``scripts/scenario_ladder.py``
    ``_s2_build_churn``: ``(build, churn)``.  ``build()`` makes the kubemark
    density cluster (``make_kubemark_density_cluster``'s nodes and pods,
    drawn from ``numpy.random.default_rng(0)`` in the ladder's order);
    ``churn(cache, rng, i)`` deletes a tenth of the live sleep pods (drawn
    by ``rng``) and adds as many new ones.  Here every shadow PodGroup takes
    its pod's creation time (``pin_shadow_timestamps``), so two builds order
    their jobs alike."""
    import numpy as np

    alive = {"pods": [], "gen": 0}

    def make_pod(rng, name, idx):
        pod = PodSpec(
            name=name, namespace="d", scheduler_name="volcano",
            containers=[{"cpu": float(rng.choice([100, 200, 500])),
                         "memory": float(rng.choice([1, 2])) * 2**30}],
            node_selector={"zone": f"z{idx % 4}"} if idx % 2 == 0 else {})
        pod.creation_timestamp = KUBEMARK_TS0 + idx * 1e-6
        return pod

    def build():
        rng = np.random.default_rng(0)
        cache = SchedulerCache(vocab=ResourceVocabulary(), async_io=False)
        cache.run()
        cache.add_queue(Queue(name="default", weight=1))
        for i in range(n_nodes):
            cache.add_node(NodeSpec(name=f"hollow-{i:05d}", allocatable={
                "cpu": 16000.0, "memory": 64 * GIB, "pods": 110},
                labels={"zone": f"z{i % 4}"}))
        for t in range(n_pods):
            pod = make_pod(rng, f"sleep-{t:05d}", t)
            cache.add_pod(pod)
            alive["pods"].append(pod)
        pin_shadow_timestamps(cache)
        return cache

    def churn(cache, rng, i):
        del i
        k = max(1, n_pods // 10)
        idx = rng.choice(len(alive["pods"]), size=k, replace=False)
        for j in sorted(set(idx.tolist()), reverse=True):
            cache.delete_pod(alive["pods"][j])
            alive["pods"][j] = alive["pods"][-1]
            alive["pods"].pop()
        base = alive["gen"] * n_pods + n_pods
        alive["gen"] += 1
        for t in range(k):
            pod = make_pod(rng, f"sleep-g{alive['gen']}-{t:05d}", base + t)
            cache.add_pod(pod)
            alive["pods"].append(pod)
        pin_shadow_timestamps(cache)

    return build, churn
