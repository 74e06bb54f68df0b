"""The port's wire codecs (``scheduler_tpu_torch/connector/wire.py``) against
the JAX package's (``scheduler_tpu/connector/wire.py``): the same compact and
``kubectl``-shaped documents parse to the same objects field by field, the
affinity codec round-trips, and the k8s path and identity helpers agree."""

from __future__ import annotations

import dataclasses
import json

import pytest

from scheduler_tpu.connector import wire as jwire
from scheduler_tpu_torch.connector import wire as twire

AFFINITY = {
    "nodeAffinity": {
        "required": [
            [{"key": "zone", "operator": "In", "values": ["z1", "z2"]}],
            [{"key": "tier", "operator": "Exists"}],
        ],
        "preferred": [
            {"weight": 10, "terms": [{"key": "zone", "operator": "In", "values": ["z1"]}]},
        ],
    },
    "podAffinity": [{"labelSelector": {"app": "db"}, "topologyKey": "zone"}],
    "podAntiAffinity": [{"labelSelector": {"app": "web"}}],
    "podPreferred": [{"weight": 5, "term": {"labelSelector": {"app": "cache"},
                                            "topologyKey": "zone"}}],
    "podAntiPreferred": [{"weight": 3, "term": {"labelSelector": {"app": "batch"}}}],
}

K8S_AFFINITY = {
    "nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {"nodeSelectorTerms": [
            {"matchExpressions": [{"key": "zone", "operator": "In", "values": ["z1"]}]},
        ]},
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 7, "preference": {"matchExpressions": [
                {"key": "disk", "operator": "In", "values": ["ssd"]}]}},
        ],
    },
    "podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "web"}},
             "topologyKey": "kubernetes.io/hostname"},
        ],
    },
}

# (kind, document): the compact dialect, then kubectl-shaped documents.
DOCS = {
    "compact_pod": ("pod", {
        "name": "p0", "namespace": "ns1", "group": "g0", "priority": 3,
        "containers": [{"cpu": 500, "memory": 2**30}, {"cpu": 250, "nvidia.com/gpu": 1}],
        "initContainers": [{"cpu": 2000, "memory": 2**31}],
        "labels": {"app": "etl"}, "nodeSelector": {"zone": "z1"},
        "tolerations": [{"key": "gpu", "operator": "Exists", "effect": "NoSchedule"}],
        "hostPorts": [8080], "affinity": AFFINITY, "volumeClaims": ["pvc-a", "pvc-b"],
        "creationTimestamp": 1714564800.5, "schedulerName": "volcano",
    }),
    "compact_bound_pod": ("pod", {
        "name": "p1", "uid": "uid-p1", "nodeName": "n0", "phase": "Running",
        "containers": [{"cpu": 100}],
    }),
    "compact_node": ("node", {
        "name": "n0", "labels": {"zone": "z1"},
        "allocatable": {"cpu": 4000, "memory": 8 * 2**30, "pods": 110},
        "capacity": {"cpu": 4000, "memory": 8 * 2**30, "pods": 110},
        "taints": [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}],
        "conditions": {"Ready": "False"}, "unschedulable": True,
    }),
    "compact_pod_group": ("podgroup", {
        "name": "g0", "namespace": "ns1", "minMember": 4, "queue": "q1",
        "phase": "Running", "running": 2, "succeeded": 1, "failed": 0,
        "priorityClassName": "high", "minResources": {"cpu": 4000},
        "conditions": [{"type": "Unschedulable", "status": "True", "reason": "r",
                        "message": "m", "transitionID": "t1",
                        "lastTransitionTime": 1714564802.0}],
    }),
    "compact_queue": ("queue", {"name": "q1", "weight": 3, "capability": {"cpu": 64000}}),
    "kubectl_pod": ("pod", {
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {
            "name": "heavy-init", "namespace": "prod", "uid": "uid-123",
            "creationTimestamp": "2024-05-01T12:00:00Z", "labels": {"app": "etl"},
            "annotations": {"scheduling.k8s.io/group-name": "g1"},
        },
        "spec": {
            "schedulerName": "volcano", "nodeSelector": {"disk": "ssd"},
            "priority": 7, "affinity": K8S_AFFINITY,
            "containers": [
                {"name": "main", "resources": {"requests": {"cpu": "500m", "memory": "1Gi"}},
                 "ports": [{"containerPort": 80, "hostPort": 8080}]},
                {"name": "side",
                 "resources": {"requests": {"cpu": "250m", "memory": "256Mi"}}},
            ],
            "initContainers": [
                {"name": "loader", "resources": {"requests": {"cpu": "3", "memory": "4Gi"}}},
            ],
            "volumes": [
                {"name": "data", "persistentVolumeClaim": {"claimName": "pvc-a"}},
                {"name": "tmp", "emptyDir": {}},
            ],
            "tolerations": [{"key": "gpu", "operator": "Exists", "effect": "NoSchedule"}],
        },
        "status": {"phase": "Pending"},
    }),
    "kubectl_bound_pod": ("pod", {
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {"name": "web-0", "namespace": "default", "resourceVersion": "42",
                     "creationTimestamp": "2024-05-01T12:00:00.123456Z"},
        "spec": {"nodeName": "worker-1", "containers": [
            {"name": "c", "resources": {"requests": {"cpu": "1", "memory": "128Mi"}}}]},
        "status": {"phase": "Running"},
    }),
    "kubectl_node": ("node", {
        "kind": "Node", "apiVersion": "v1",
        "metadata": {"name": "worker-1", "labels": {"zone": "z1"}},
        "spec": {"taints": [{"key": "dedicated", "value": "ml", "effect": "NoSchedule"}]},
        "status": {
            "allocatable": {"cpu": "63500m", "memory": "250Gi", "pods": "110",
                            "nvidia.com/gpu": "8"},
            "capacity": {"cpu": "64", "memory": "256Gi", "pods": "110"},
            "conditions": [{"type": "Ready", "status": "True"},
                           {"type": "MemoryPressure", "status": "False"}],
        },
    }),
    "kubectl_pod_group": ("podgroup", {
        "apiVersion": "scheduling.volcano.sh/v1beta1", "kind": "PodGroup",
        "metadata": {"name": "train-42", "namespace": "ml",
                     "creationTimestamp": "2024-05-01T00:00:00Z"},
        "spec": {"minMember": 8, "queue": "research",
                 "minResources": {"cpu": "16", "memory": "64Gi"},
                 "priorityClassName": "high"},
        "status": {"phase": "Inqueue", "running": 1},
    }),
    "kubectl_queue": ("queue", {
        "apiVersion": "scheduling.volcano.sh/v1beta1", "kind": "Queue",
        "metadata": {"name": "research"},
        "spec": {"weight": 4, "capability": {"cpu": "100", "memory": "1Ti"}},
    }),
}

PARSERS = {"pod": "parse_pod", "node": "parse_node", "podgroup": "parse_pod_group",
           "queue": "parse_queue"}


def _canon(obj, keep_uid: bool, keep_ts: bool) -> dict:
    """The parsed object as a plain dict, without what each process makes up
    on its own: a generated uid and a creation time of ``now``."""
    out = json.loads(json.dumps(dataclasses.asdict(obj), default=str))
    if not keep_uid:
        out.pop("uid", None)
    if not keep_ts:
        out.pop("creation_timestamp", None)
    return out


def _has_ts(doc: dict) -> bool:
    meta = doc.get("metadata")
    return "creationTimestamp" in (meta if isinstance(meta, dict) else doc)


@pytest.mark.parametrize("case", sorted(DOCS))
def test_document_parses_as_in_jax(case):
    kind, doc = DOCS[case]
    fn = PARSERS[kind]
    jobj = getattr(jwire, fn)(json.loads(json.dumps(doc)))
    tobj = getattr(twire, fn)(json.loads(json.dumps(doc)))
    keep_uid = kind == "pod"  # pods take the wire identity; groups a counter
    ours = _canon(tobj, keep_uid, _has_ts(doc))
    assert ours == _canon(jobj, keep_uid, _has_ts(doc))
    assert ours  # the document carried fields


@pytest.mark.parametrize("case", ["compact", "k8s"])
def test_encode_affinity_round_trips(case):
    def parsed(wire):
        if case == "compact":
            return wire.parse_affinity(json.loads(json.dumps(AFFINITY)))
        return wire.parse_pod(json.loads(json.dumps(DOCS["kubectl_pod"][1]))).affinity

    ours = parsed(twire)
    encoded = twire.encode_affinity(ours)
    assert encoded == jwire.encode_affinity(parsed(jwire))
    again = twire.parse_affinity(encoded)
    assert dataclasses.asdict(again) == dataclasses.asdict(ours)
    assert twire.encode_affinity(None) is None


@pytest.mark.parametrize("case", sorted(DOCS))
def test_identity_helpers_agree(case):
    kind, doc = DOCS[case]
    doc = json.loads(json.dumps(doc))
    if kind in ("pod", "podgroup"):
        key = twire.pod_key(doc)
        assert key == jwire.pod_key(doc)
    else:
        key = twire.obj_name(doc)
        assert key == jwire.obj_name(doc)
    assert twire.object_path(kind, key) == jwire.object_path(kind, key)
    assert twire.obj_rv(doc) == jwire.obj_rv(doc)
    if kind == "pod":
        assert twire.pod_uid(doc) == jwire.pod_uid(doc)


def test_k8s_tables_agree():
    assert twire.CRD_PREFIX == jwire.CRD_PREFIX
    assert twire.LIST_RESOURCES == jwire.LIST_RESOURCES
    assert twire.WATCH_OPS == jwire.WATCH_OPS
    for raw in ({"metadata": {"resourceVersion": "17"}}, {"resourceVersion": 9},
                {"resourceVersion": "x"}, {}):
        assert twire.obj_rv(raw) == jwire.obj_rv(raw)
    assert twire.object_path("priorityclass", "high") == jwire.object_path("priorityclass", "high")
    with pytest.raises(ValueError):
        twire.object_path("lease", "x")
