"""The port's proportion and conformance plugins against the JAX package's,
on the CPU.

The same cluster is built in both packages (same objects, same timestamps)
and a session opened on each, with the JAX package on proportion's host
water-fill (``SCHEDULER_TPU_QFAIR=host``), the port's only one.  The
plugins' state and callbacks must agree exactly (tolerance: none; the
deserved rows are the same float64 fold): per queue the deserved, allocated
and request vectors and the share, the queue order, the overused gate, the
job-enqueueable quota, proportion's reclaimable walk and conformance's
critical-pod veto, and the queue attributes after a committed allocate.
"""

import functools
import importlib

import numpy as np
import pytest

import scheduler_tpu.actions  # noqa: F401  registry side effects
import scheduler_tpu.plugins  # noqa: F401
import scheduler_tpu_torch.actions  # noqa: F401
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import DEFAULT_TIERS_CONF

PKGS = ("scheduler_tpu", "scheduler_tpu_torch")
GIB = 2.0**30
TS0 = 1_700_000_000.0

PROPORTION_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: proportion
  - name: binpack
"""


@pytest.fixture(autouse=True)
def _host_water_fill(monkeypatch):
    monkeypatch.setenv("SCHEDULER_TPU_QFAIR", "host")


def queue_cluster(pkg, n_queues, seed):
    """``n_queues`` queues, the last of them holding no job: q0 of weight 1
    with a capability, the others of weights from ``default_rng(seed)``;
    12 nodes of 8 cpu and 32 GiB and 4 more that hold q0's running "hog"
    gang of 7-cpu, 30-GiB pods (so q0 holds more than it deserves: overused, and
    the reclaimable walk accepts victims); jobs of 2 to 5 pods dealt to
    the queues with jobs, some pods running and the rest pending, plus one
    8-cpu pending pod each (demand past the cluster's capacity, so the
    water-fill splits it by weight); every job with a minimum resource
    request (the enqueue quota)."""
    rng = np.random.default_rng(seed)
    objects = importlib.import_module(f"{pkg}.apis.objects")
    vocab = importlib.import_module(f"{pkg}.api.vocab")
    cache = importlib.import_module(f"{pkg}.cache.cache").SchedulerCache(
        vocab=vocab.ResourceVocabulary(), async_io=False)
    cache.run()
    for q in range(n_queues):
        queue = objects.Queue(name=f"q{q}", weight=1 if q == 0 else int(rng.integers(4, 9)),
                              capability={"cpu": 20_000.0} if q == 0 else {})
        queue.creation_timestamp = TS0 + q * 1e-6
        cache.add_queue(queue)
    for name in [f"n{i:02d}" for i in range(12)] + [f"hog{i}" for i in range(4)]:
        cache.add_node(objects.NodeSpec(name=name, allocatable={
            "cpu": 8000.0, "memory": 32 * GIB, "pods": 110}))
    k = 0

    def add_job(j, group, queue, pods):
        namespace = "default" if j % 4 else "kube-system"
        pg = objects.PodGroup(name=group, namespace=namespace, queue=queue,
                              min_member=1, min_resources={"cpu": 2000.0})
        pg.status.phase = "Inqueue"
        pg.creation_timestamp = TS0 + 1.0 + j * 1e-3
        cache.add_pod_group(pg)
        for t, (cpu, node) in enumerate(pods):
            nonlocal k
            memory = 30 * GIB if cpu == 7000.0 else float(rng.choice([1, 2, 4])) * GIB
            pod = objects.PodSpec(
                name=f"{group}-{t}", namespace=namespace,
                containers=[{"cpu": cpu, "memory": memory}],
                phase="Running" if node else "Pending", node_name=node,
                priority=int(rng.integers(0, 3)),
                priority_class_name="system-node-critical" if t == 1 else "",
                annotations={objects.GROUP_NAME_ANNOTATION: group})
            pod.creation_timestamp = TS0 + 2.0 + k * 1e-6
            cache.add_pod(pod)
            k += 1

    add_job(0, "hog", "q0", [(7000.0, f"hog{i}") for i in range(4)] + [(1000.0, "")])
    for j in range(1, 3 * n_queues):
        size = int(rng.integers(2, 6))
        running = int(rng.integers(0, size))
        pods = [(float(rng.choice([250, 500, 1000, 1500])),
                 f"n{(k + t) % 12:02d}" if t < running else "") for t in range(size)]
        add_job(j, f"job{j:02d}", f"q{j % (n_queues - 1)}", pods + [(8000.0, "")])
    return cache


def open_in(pkg, cache, conf_text):
    conf = importlib.import_module(f"{pkg}.conf")
    framework = importlib.import_module(f"{pkg}.framework")
    kw = {"device": "cpu"} if pkg == "scheduler_tpu_torch" else {}
    return framework.open_session(cache, conf.parse_scheduler_conf(conf_text).tiers, **kw)


def queue_state(ssn):
    """Per queue: the plugin's deserved, allocated and request vectors and
    share (queues without jobs have no attributes), and the overused gate."""
    plugin = ssn.plugins["proportion"]
    out = {}
    for uid, queue in ssn.queues.items():
        attr = plugin.queue_attrs.get(uid)
        vecs = None if attr is None else tuple(
            tuple(v.array.tolist()) for v in (attr.deserved, attr.allocated, attr.request))
        out[uid] = (vecs, None if attr is None else attr.share,
                    None if attr is None else ssn.overused_fns["proportion"](queue))
    return out


def queue_order(ssn):
    """The queues with jobs, sorted by proportion's queue order (a stable
    sort from the creation order, so ties keep it)."""
    plugin = ssn.plugins["proportion"]
    fn = ssn.queue_order_fns["proportion"]
    queues = sorted((ssn.queues[uid] for uid in plugin.queue_attrs),
                    key=lambda q: (q.creation_timestamp, q.name))
    return [q.name for q in sorted(queues, key=functools.cmp_to_key(fn))]


def running_tasks(ssn):
    return sorted((t for job in ssn.jobs.values() for t in job.tasks.values()
                   if t.node_name), key=lambda t: t.name)


def victims_of(fn, reclaimer, reclaimees):
    chosen = fn(reclaimer, reclaimees)
    return None if chosen is None else sorted(t.name for t in chosen)


@pytest.mark.parametrize("n_queues,seed", [(2, 0), (3, 1), (4, 2), (5, 3)])
def test_proportion_matches_jax(n_queues, seed):
    states, orders, enqueue, reclaim = [], [], [], []
    for pkg in PKGS:
        ssn = open_in(pkg, queue_cluster(pkg, n_queues, seed), PROPORTION_CONF)
        states.append(queue_state(ssn))
        orders.append(queue_order(ssn))
        enqueue.append({j.name: ssn.job_enqueueable_fns["proportion"](j)
                        for j in ssn.jobs.values()})
        running = running_tasks(ssn)
        fn = ssn.reclaimable_fns["proportion"]
        # Every running task as a victim, and each queue's running tasks apart.
        by_queue = [[t for t in running if ssn.jobs[t.job].queue == f"q{q}"]
                    for q in range(n_queues)]
        reclaim.append([victims_of(fn, running[0], group) for group in [running] + by_queue])
    assert states[1] == states[0]
    assert orders[1] == orders[0]
    assert enqueue[1] == enqueue[0]
    assert reclaim[1] == reclaim[0]
    state = states[1]
    empty = f"q{n_queues - 1}"
    assert state[empty] == (None, None, None), "the queue with no jobs has no attributes"
    shares = [share for vecs, share, _ in state.values() if vecs is not None]
    assert all(s > 0.0 for s in shares), "every queue with running pods has a share"
    if n_queues > 2:
        # q0 holds more than its weight's share of a cluster in demand.
        assert state["q0"][2], "q0 is overused"
        assert any(reclaim[1]), "the reclaimable walk accepts some victims"


def test_conformance_veto_matches_jax():
    """conformance's preemptable and reclaimable fn: critical pods (priority
    class system-node-critical, or namespace kube-system) are never victims;
    a list of critical pods only leaves none (None)."""
    outcomes = []
    for pkg in PKGS:
        ssn = open_in(pkg, queue_cluster(pkg, 3, 4), PROPORTION_CONF)
        running = running_tasks(ssn)
        critical = [t for t in running if t.pod.priority_class_name or
                    t.pod.namespace == "kube-system"]
        assert critical and len(critical) < len(running)
        got = []
        for fns in (ssn.preemptable_fns, ssn.reclaimable_fns):
            fn = fns["conformance"]
            got.append((victims_of(fn, running[0], running), victims_of(fn, running[0], critical)))
        outcomes.append((got, sorted(t.name for t in running if t not in critical)))
    assert outcomes[1] == outcomes[0]
    got, plain = outcomes[1]
    for victims, none in got:
        assert victims == plain
        assert none is None


@pytest.mark.parametrize("conf", [PROPORTION_CONF, DEFAULT_TIERS_CONF],
                         ids=["proportion", "default-tiers"])
def test_queue_attrs_after_commit_match_jax(conf):
    """One allocate action through the fused route in each package (the
    port's plain mega kernel in multi-queue mode), then proportion's queue
    attributes after the commit's bulk event: allocated and share as the
    next cycle would read them."""
    from scheduler_tpu_torch.actions import allocate as torch_allocate

    states, binds = [], []
    for pkg in PKGS:
        cache = queue_cluster(pkg, 4, 5)
        ssn = open_in(pkg, cache, conf)
        fused = dict(torch_allocate.routes)["fused"]
        importlib.import_module(f"{pkg}.framework").get_action("allocate").execute(ssn)
        if pkg == "scheduler_tpu_torch":
            assert torch_allocate.routes["fused"] == fused + 1
        states.append(queue_state(ssn))
        importlib.import_module(f"{pkg}.framework").close_session(ssn)
        binds.append(dict(cache.binder.binds))
    assert binds[1] == binds[0] and binds[1]
    assert states[1] == states[0]
