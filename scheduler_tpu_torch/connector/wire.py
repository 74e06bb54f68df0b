"""Wire codecs: the JSON object schemas shared by the cluster-state file, the
API-server connector, and the mock server.

TWO dialects, one parser surface:

* the COMPACT dialect (flat ``{"name", "containers": [{"cpu": ...}], ...}``
  documents) used by the synthetic drivers and the deploy examples;
* REAL Kubernetes object shapes — ``metadata``/``spec``/``status`` envelopes,
  ``resources.requests`` quantity strings ("500m", "1Gi"), ``initContainers``,
  k8s affinity/toleration/taint structures — exactly what
  ``kubectl get -o json`` emits and what the reference consumes through
  client-go (``pkg/scheduler/cache/cache.go:256-336``).

Every ``parse_*`` sniffs the envelope (``"metadata" in obj``) and routes, so
all three consumers (``--cluster-state`` preload, the connector's list+watch
ingestion, test drivers against the mock server) accept both dialects; the
fixture tests pin real ``kubectl``-shaped documents end to end.
"""

from __future__ import annotations

import calendar
import datetime
import re
import time
from typing import Dict, List, Optional

from scheduler_tpu_torch.apis.objects import (
    GROUP_NAME_ANNOTATION,
    Affinity,
    NodeSelectorRequirement,
    NodeSpec,
    PodAffinityTerm,
    PodGroup,
    PodSpec,
    Queue,
    Taint,
    Toleration,
)

# -- k8s resource.Quantity ----------------------------------------------------

_BIN = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18}
_QTY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]*)$")


def parse_quantity(q) -> float:
    """k8s ``resource.Quantity`` string (or bare number) -> float in base
    units (cores / bytes / counts)."""
    if isinstance(q, (int, float)):
        return float(q)
    m = _QTY_RE.match(str(q).strip())
    if not m:
        raise ValueError(f"malformed quantity {q!r}")
    value, suffix = float(m.group(1)), m.group(2)
    if not suffix:
        return value
    if suffix in _BIN:
        return value * _BIN[suffix]
    if suffix in _DEC:
        return value * _DEC[suffix]
    raise ValueError(f"unknown quantity suffix {q!r}")


def _requests_to_canonical(requests: Dict) -> Dict[str, float]:
    """``resources.requests`` -> the canonical units the scheduler accounts
    in: cpu in MILLIcores (resource_info.go NewResource does the same 1000x),
    everything else in base units (bytes / counts)."""
    out: Dict[str, float] = {}
    for name, q in (requests or {}).items():
        v = parse_quantity(q)
        out[name] = v * 1000.0 if name == "cpu" else v
    return out


def _parse_k8s_time(ts) -> Optional[float]:
    """Tolerant RFC3339: k8s JSON carries metav1.Time (whole seconds, 'Z')
    but metav1.MicroTime and third-party producers emit fractional seconds
    and numeric UTC offsets.  An unparseable timestamp is treated as absent
    rather than raised — one bad doc must not wedge ingestion (the resync
    path would refetch the same doc and fail forever)."""
    if ts is None:
        return None
    if isinstance(ts, (int, float)):
        return float(ts)
    s = str(ts)
    try:
        return float(calendar.timegm(time.strptime(s, "%Y-%m-%dT%H:%M:%SZ")))
    except ValueError:
        pass
    try:
        if s.endswith(("Z", "z")):
            s = s[:-1] + "+00:00"
        dt = datetime.datetime.fromisoformat(s)
        if dt.tzinfo is None:
            # k8s timestamps are UTC; a naive .timestamp() would apply the
            # HOST zone (silently skewed epochs) and can raise OSError via
            # mktime for out-of-range dates.
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        return dt.timestamp()
    except (ValueError, OverflowError, OSError):
        return None


def _is_k8s(obj: Dict) -> bool:
    return isinstance(obj.get("metadata"), dict)


def parse_queue(q: Dict) -> Queue:
    if _is_k8s(q):
        meta, spec = q["metadata"], q.get("spec", {})
        return Queue(
            name=meta["name"],
            weight=int(spec.get("weight", 1)),
            capability=_requests_to_canonical(spec.get("capability") or {}),
        )
    return Queue(
        name=q["name"],
        weight=int(q.get("weight", 1)),
        capability=q.get("capability", {}),
    )


def _parse_k8s_node(n: Dict) -> NodeSpec:
    """Real ``v1.Node`` JSON (kubectl get node -o json)."""
    meta, spec, status = n["metadata"], n.get("spec", {}), n.get("status", {})
    conditions = {
        c["type"]: str(c.get("status", "True"))
        for c in status.get("conditions", [])
    }

    allocatable = _requests_to_canonical(
        status.get("allocatable", status.get("capacity", {}))
    )
    return NodeSpec(
        name=meta["name"],
        allocatable=allocatable,
        capacity=_requests_to_canonical(status.get("capacity", {})) or dict(allocatable),
        labels=meta.get("labels", {}) or {},
        taints=[
            Taint(
                key=t["key"],
                value=str(t.get("value", "")),
                effect=t.get("effect", "NoSchedule"),
            )
            for t in spec.get("taints", []) or []
        ],
        unschedulable=bool(spec.get("unschedulable", False)),
        conditions=conditions,
    )


def parse_node(n: Dict) -> NodeSpec:
    if _is_k8s(n):
        return _parse_k8s_node(n)
    # Conditions arrive either as {type: status} or k8s-style
    # [{"type": ..., "status": ...}] — both normalize to the dict form the
    # predicates plugin checks (ready / memory / disk / PID pressure;
    # reference predicates.go:169-276).
    raw_conds = n.get("conditions", {})
    if isinstance(raw_conds, list):
        conditions = {c["type"]: str(c.get("status", "True")) for c in raw_conds}
    else:
        conditions = {k: str(v) for k, v in raw_conds.items()}
    return NodeSpec(
        name=n["name"],
        allocatable={k: float(v) for k, v in n.get("allocatable", {}).items()},
        capacity={
            k: float(v)
            for k, v in n.get("capacity", n.get("allocatable", {})).items()
        },
        labels=n.get("labels", {}),
        taints=[Taint(**t) for t in n.get("taints", [])],
        unschedulable=bool(n.get("unschedulable", False)),
        conditions=conditions,
    )


def _parse_requirement(r: Dict) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(
        key=r["key"],
        operator=r.get("operator", "In"),
        values=[str(v) for v in r.get("values", [])],
    )


def _parse_pod_affinity_terms(terms: List[Dict]) -> List[PodAffinityTerm]:
    return [
        PodAffinityTerm(
            label_selector={k: str(v) for k, v in t.get("labelSelector", {}).items()},
            topology_key=t.get("topologyKey", "kubernetes.io/hostname"),
            namespaces=list(t.get("namespaces", [])),
        )
        for t in terms
    ]


def parse_affinity(a: Optional[Dict]) -> Optional[Affinity]:
    """Affinity wire schema → Affinity.

    ``nodeAffinity.required`` is a list of term groups (OR across groups, AND
    within — nodeSelectorTerms semantics); ``preferred`` is
    ``[{"weight": W, "terms": [...]}]``; ``podAffinity`` / ``podAntiAffinity``
    are lists of ``{"labelSelector", "topologyKey", "namespaces"}`` terms
    (reference predicates.go:278-296 consumes the same shapes from the pod spec).
    """
    if not a:
        return None
    node = a.get("nodeAffinity", {})

    def weighted_terms(key: str):
        return [
            (int(p.get("weight", 1)), _parse_pod_affinity_terms([p.get("term", p)])[0])
            for p in a.get(key, [])
        ]

    return Affinity(
        node_required=[
            [_parse_requirement(r) for r in group]
            for group in node.get("required", [])
        ],
        node_preferred=[
            (int(p.get("weight", 1)), [_parse_requirement(r) for r in p.get("terms", [])])
            for p in node.get("preferred", [])
        ],
        pod_affinity=_parse_pod_affinity_terms(a.get("podAffinity", [])),
        pod_anti_affinity=_parse_pod_affinity_terms(a.get("podAntiAffinity", [])),
        pod_preferred=weighted_terms("podPreferred"),
        pod_anti_preferred=weighted_terms("podAntiPreferred"),
    )


def encode_affinity(a: Optional[Affinity]) -> Optional[Dict]:
    """Inverse of ``parse_affinity`` (used by workload drivers and tests)."""
    if a is None:
        return None
    return {
        "nodeAffinity": {
            "required": [
                [{"key": r.key, "operator": r.operator, "values": list(r.values)}
                 for r in group]
                for group in a.node_required
            ],
            "preferred": [
                {"weight": w,
                 "terms": [{"key": r.key, "operator": r.operator, "values": list(r.values)}
                           for r in reqs]}
                for w, reqs in a.node_preferred
            ],
        },
        "podAffinity": [
            {"labelSelector": dict(t.label_selector), "topologyKey": t.topology_key,
             "namespaces": list(t.namespaces)}
            for t in a.pod_affinity
        ],
        "podAntiAffinity": [
            {"labelSelector": dict(t.label_selector), "topologyKey": t.topology_key,
             "namespaces": list(t.namespaces)}
            for t in a.pod_anti_affinity
        ],
        "podPreferred": [
            {"weight": w,
             "term": {"labelSelector": dict(t.label_selector),
                      "topologyKey": t.topology_key, "namespaces": list(t.namespaces)}}
            for w, t in a.pod_preferred
        ],
        "podAntiPreferred": [
            {"weight": w,
             "term": {"labelSelector": dict(t.label_selector),
                      "topologyKey": t.topology_key, "namespaces": list(t.namespaces)}}
            for w, t in a.pod_anti_preferred
        ],
    }


def _parse_pg_condition(c: Dict):
    """One wire PodGroup condition.  Fidelity matters: the scheduler's OWN
    status pushes echo back through the watch stream, and a lossy parse
    (dropping message/transitionID) would make every close-time status diff
    read "changed" and re-push — a self-sustaining event loop under
    event-triggered cycles (docs/CHURN.md)."""
    from scheduler_tpu_torch.apis.objects import PodGroupCondition

    ts = c.get("lastTransitionTime")
    if isinstance(ts, (int, float)):
        when = float(ts)
    else:
        when = _parse_k8s_time(ts) or 0.0
    return PodGroupCondition(
        type=str(c.get("type", "")),
        status=str(c.get("status", "True")),
        reason=str(c.get("reason", "")),
        message=str(c.get("message", "")),
        transition_id=str(c.get("transitionID", "")),
        last_transition_time=when,
    )


def _parse_pg_status(pg: PodGroup, status: Dict) -> None:
    """Status fields shared by both dialects (phase handled by callers —
    the compact dialect carries it at top level)."""
    for key in ("running", "succeeded", "failed"):
        if status.get(key) is not None:
            setattr(pg.status, key, int(status[key]))
    if status.get("conditions"):
        pg.status.conditions = [
            _parse_pg_condition(c) for c in status["conditions"]
        ]


def parse_pod_group(g: Dict) -> PodGroup:
    if _is_k8s(g):
        meta, spec, status = g["metadata"], g.get("spec", {}), g.get("status", {})
        pg = PodGroup(
            name=meta["name"],
            namespace=meta.get("namespace", "default"),
            queue=spec.get("queue", ""),
            min_member=int(spec.get("minMember", 1)),
            min_resources=(
                _requests_to_canonical(spec["minResources"])
                if spec.get("minResources")
                else None
            ),
        )
        if meta.get("uid"):
            pg.uid = meta["uid"]
        ts = _parse_k8s_time(meta.get("creationTimestamp"))
        if ts is not None:
            pg.creation_timestamp = ts
        if status.get("phase"):
            pg.status.phase = status["phase"]
        _parse_pg_status(pg, status)
        if spec.get("priorityClassName"):
            pg.priority_class_name = spec["priorityClassName"]
        return pg
    pg = PodGroup(
        name=g["name"],
        namespace=g.get("namespace", "default"),
        queue=g.get("queue", ""),
        min_member=int(g.get("minMember", 1)),
        min_resources=g.get("minResources"),
    )
    if g.get("phase"):
        pg.status.phase = g["phase"]
    _parse_pg_status(pg, g)
    if g.get("priorityClassName"):
        pg.priority_class_name = g["priorityClassName"]
    return pg


def _parse_k8s_pod_affinity_term(t: Dict) -> PodAffinityTerm:
    sel = t.get("labelSelector", {}) or {}
    return PodAffinityTerm(
        label_selector={k: str(v) for k, v in sel.get("matchLabels", {}).items()},
        topology_key=t.get("topologyKey", "kubernetes.io/hostname"),
        namespaces=list(t.get("namespaces", []) or []),
        expressions=[_parse_requirement(r) for r in sel.get("matchExpressions", []) or []],
    )


def _parse_k8s_affinity(a: Optional[Dict]) -> Optional[Affinity]:
    """Real ``v1.Affinity``: requiredDuringSchedulingIgnoredDuringExecution /
    preferredDuringSchedulingIgnoredDuringExecution structures."""
    if not a:
        return None
    REQ = "requiredDuringSchedulingIgnoredDuringExecution"
    PREF = "preferredDuringSchedulingIgnoredDuringExecution"
    out = Affinity()
    node = a.get("nodeAffinity") or {}
    req = node.get(REQ) or {}
    out.node_required = [
        [_parse_requirement(r) for r in term.get("matchExpressions", [])]
        for term in req.get("nodeSelectorTerms", [])
    ]
    out.node_preferred = [
        (
            int(p.get("weight", 1)),
            [_parse_requirement(r) for r in (p.get("preference") or {}).get("matchExpressions", [])],
        )
        for p in node.get(PREF, []) or []
    ]
    pa = a.get("podAffinity") or {}
    out.pod_affinity = [_parse_k8s_pod_affinity_term(t) for t in pa.get(REQ, []) or []]
    out.pod_preferred = [
        (int(p.get("weight", 1)), _parse_k8s_pod_affinity_term(p.get("podAffinityTerm", {})))
        for p in pa.get(PREF, []) or []
    ]
    paa = a.get("podAntiAffinity") or {}
    out.pod_anti_affinity = [_parse_k8s_pod_affinity_term(t) for t in paa.get(REQ, []) or []]
    out.pod_anti_preferred = [
        (int(p.get("weight", 1)), _parse_k8s_pod_affinity_term(p.get("podAffinityTerm", {})))
        for p in paa.get(PREF, []) or []
    ]
    return out


def _parse_k8s_pod(p: Dict, default_scheduler: str) -> PodSpec:
    """Real ``v1.Pod`` JSON: metadata/spec/status envelope,
    ``resources.requests`` quantities, ``initContainers`` (the
    max(sum(containers), max(init)) rule — pod_info.go:53-76 — needs them),
    hostPorts from container ports, PVC claims from volumes."""
    meta, spec, status = p["metadata"], p.get("spec", {}), p.get("status", {})

    def container_requests(key: str) -> List[Dict[str, float]]:
        return [
            _requests_to_canonical((c.get("resources") or {}).get("requests", {}))
            for c in spec.get(key, []) or []
        ]

    host_ports = [
        int(port["hostPort"])
        for c in spec.get("containers", []) or []
        for port in c.get("ports", []) or []
        if port.get("hostPort")
    ]
    claims = [
        v["persistentVolumeClaim"]["claimName"]
        for v in spec.get("volumes", []) or []
        if v.get("persistentVolumeClaim", {}).get("claimName")
    ]
    pod = PodSpec(
        name=meta["name"],
        namespace=meta.get("namespace", "default"),
        containers=container_requests("containers"),
        init_containers=container_requests("initContainers"),
        phase=status.get("phase", "Pending"),
        node_name=spec.get("nodeName", ""),
        priority=int(spec.get("priority", 0)),
        labels=meta.get("labels", {}) or {},
        annotations=dict(meta.get("annotations", {}) or {}),
        node_selector=spec.get("nodeSelector", {}) or {},
        tolerations=[
            Toleration(
                key=t.get("key", ""),
                operator=t.get("operator", "Equal"),
                value=str(t.get("value", "")),
                effect=t.get("effect", ""),
            )
            for t in spec.get("tolerations", []) or []
        ],
        scheduler_name=spec.get("schedulerName", default_scheduler),
    )
    if spec.get("priorityClassName"):
        pod.priority_class_name = spec["priorityClassName"]
    if meta.get("uid"):
        pod.uid = meta["uid"]
    else:
        pod.uid = f"{pod.namespace}/{pod.name}"
    ts = _parse_k8s_time(meta.get("creationTimestamp"))
    if ts is not None:
        pod.creation_timestamp = ts
    if host_ports:
        pod.host_ports = host_ports
    if spec.get("affinity"):
        pod.affinity = _parse_k8s_affinity(spec["affinity"])
    if claims:
        pod.volume_claims = claims
    return pod


def parse_pod(p: Dict, default_scheduler: str = "volcano") -> PodSpec:
    if _is_k8s(p):
        return _parse_k8s_pod(p, default_scheduler)
    annotations = dict(p.get("annotations", {}))
    if p.get("group"):
        annotations[GROUP_NAME_ANNOTATION] = p["group"]
    pod = PodSpec(
        name=p["name"],
        namespace=p.get("namespace", "default"),
        containers=[{k: float(v) for k, v in c.items()} for c in p.get("containers", [])],
        phase=p.get("phase", "Pending"),
        node_name=p.get("nodeName", ""),
        priority=int(p.get("priority", 0)),
        labels=p.get("labels", {}),
        annotations=annotations,
        node_selector=p.get("nodeSelector", {}),
        tolerations=[Toleration(**t) for t in p.get("tolerations", [])],
        scheduler_name=p.get("schedulerName", default_scheduler),
    )
    # Wire identity must be STABLE across events: the cache resolves tasks by
    # uid, so a fresh uid per watch echo would duplicate the task on every
    # update and make deletes no-ops.  The server's uid wins; absent one,
    # namespace/name IS the identity (unique in any consistent store).
    pod.uid = pod_uid(p)
    if p.get("creationTimestamp") is not None:
        pod.creation_timestamp = float(p["creationTimestamp"])
    if p.get("hostPorts"):
        pod.host_ports = [int(x) for x in p["hostPorts"]]
    if p.get("affinity"):
        pod.affinity = parse_affinity(p["affinity"])
    if p.get("initContainers"):
        # Compact-dialect init containers (same shape as "containers") — the
        # init-container max rule needs them across the wire too.
        pod.init_containers = [
            {k: float(v) for k, v in c.items()} for c in p["initContainers"]
        ]
    if p.get("volumeClaims"):
        pod.volume_claims = [str(c) for c in p["volumeClaims"]]
    return pod


# -- k8s LIST+WATCH wire tables (inbound reflector protocol) ------------------

# The CRD group the reference registers its PodGroup/Queue types under
# (pkg/apis/scheduling/v1alpha1/register.go:32).  Outbound status PATCHes
# (client.py) and the inbound reflector (reflector.py) MUST speak the same
# group — one resource, one API path.
CRD_PREFIX = "/apis/scheduling.incubator.k8s.io/v1alpha1"

# Collection path + item Kind per cache kind, in the dependency order the
# initial sync seeds them (queues/priority classes before groups before pods,
# matching the journal protocol's list_and_seed order).  These paths are the
# LIST endpoints (``GET {path}``) and, with ``?watch=1&resourceVersion=RV``,
# the WATCH streams — exactly client-go's per-resource reflector surface
# (reference cache/cache.go:256-336 builds one informer per type).
LIST_RESOURCES = (
    ("queue", CRD_PREFIX + "/queues", "Queue"),
    ("priorityclass", "/apis/scheduling.k8s.io/v1/priorityclasses",
     "PriorityClass"),
    ("node", "/api/v1/nodes", "Node"),
    ("podgroup", CRD_PREFIX + "/podgroups", "PodGroup"),
    ("pod", "/api/v1/pods", "Pod"),
)

# k8s watch-event types -> the cache's event-handler ops.  BOOKMARK and ERROR
# are protocol-level (cursor advance / stream status) and deliberately absent:
# they never reach the cache.
WATCH_OPS = {"ADDED": "add", "MODIFIED": "update", "DELETED": "delete"}


def object_path(kind: str, key: str) -> str:
    """Single-object GET path for the k8s wire (the syncTask re-fetch shape):
    namespaced kinds take ``ns/name`` keys, cluster-scoped kinds bare names."""
    if kind == "pod":
        ns, name = key.split("/", 1)
        return f"/api/v1/namespaces/{ns}/pods/{name}"
    if kind == "podgroup":
        ns, name = key.split("/", 1)
        return f"{CRD_PREFIX}/namespaces/{ns}/podgroups/{name}"
    if kind == "node":
        return f"/api/v1/nodes/{key}"
    if kind == "queue":
        return f"{CRD_PREFIX}/queues/{key}"
    if kind == "priorityclass":
        return f"/apis/scheduling.k8s.io/v1/priorityclasses/{key}"
    raise ValueError(f"unknown kind {kind!r}")


def obj_rv(obj: Dict) -> Optional[int]:
    """The wire resourceVersion of an object, in either dialect — the cursor
    the reflector advances on every applied event and bookmark.  Like
    ``pod_uid`` above, this is THE one identity-adjacent rule both the client
    and the servers must share: a server stamping RVs where the client does
    not look would freeze the cursor and replay the whole stream after every
    reconnect.  k8s envelope: ``metadata.resourceVersion``; compact dialect:
    top-level ``resourceVersion``.  Absent or malformed == None (the caller
    keeps its cursor)."""
    meta = obj.get("metadata")
    raw = (meta if isinstance(meta, dict) else obj).get("resourceVersion")
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        return None


def pod_key(obj: Dict) -> str:
    meta = obj.get("metadata")
    if isinstance(meta, dict):
        return f"{meta.get('namespace', 'default')}/{meta['name']}"
    return f"{obj.get('namespace', 'default')}/{obj['name']}"


def pod_uid(obj: Dict) -> str:
    """The wire identity rule, shared by ``parse_pod`` and the relist diff —
    the two MUST agree or a relist would prune live pods as ghosts."""
    meta = obj.get("metadata")
    if isinstance(meta, dict):
        return meta["uid"] if meta.get("uid") else pod_key(obj)
    return obj["uid"] if obj.get("uid") else pod_key(obj)


def obj_name(obj: Dict) -> str:
    """Name of a wire object in either dialect (nodes/queues/priority
    classes key on bare names)."""
    meta = obj.get("metadata")
    if isinstance(meta, dict):
        return meta["name"]
    return obj["name"]
