"""Cross-cycle engine cache: the fused engine stays resident between cycles.

A steady scheduling cycle schedules the same pending workload against
nearly the same cluster as the cycle before.  The built ``FusedAllocator``
(host layout, request tables, static mask and score rows, the mega kernel's
operands, the resident device tensors) therefore persists across cycles,
and a new session either

* **hits**: its job and queue layout token equals the resident engine's, so
  only the dynamic node state and proportion's queue rows are refreshed and
  the host bookkeeping rebinds to the new session's clones
  (``FusedAllocator.update``), or
* **rebuilds**: something layout-shaped moved (the pending set, a job's
  priority, the vocabulary, a node spec, the plugin conf), and the engine
  builds cold as before.

The key (the "session shape"): the owning cache's scope token, the node
count, the queue count, the resource vocabulary's width, the session's
plugin-tier signature, the device, and the flags that change what a build
selects (``_ENV_KEYS``).  A key change misses; the LRU cap bounds the
residents.  The layout token under a key fingerprints the candidate jobs'
stores (row count, structural generation, status and volume-ready
content), priorities, gang floors and queues, the queue set and the node-spec
generation: everything the build reads that a hit does not refresh.

The scope token is stored on the owning cache instance, so engines never
alias across caches and a recycled ``id()`` never revives a dead entry.  An
entry is popped while a session uses it and re-inserted when that session
closes (``release_session``), so two concurrent sessions never share one
engine.  This mirrors ``scheduler_tpu/ops/engine_cache.py`` with this package's
own flags; the node mesh's resolved topology (``mesh.topology_key``) is in
the key, so a resident never serves another topology.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

# The flags that change which program a build selects: a resident engine
# built under one value must not serve another.
_ENV_KEYS = (
    "SCHEDULER_TORCH_FUSED_STATIC_LIMIT",
    "SCHEDULER_TORCH_QFAIR",
    "SCHEDULER_TORCH_QFAIR_ITERS",
    "SCHEDULER_TORCH_QUEUE_DELTA",
    "SCHEDULER_TORCH_DIRTY_DELTA",
    # The allocator flavor selects the program a build stages (greedy, or the
    # LP relaxation and its repair); the LP knobs set the relaxation and its
    # admission gate; the signature-class mode its rows and the LP working
    # set.  The class table itself is layout-derived (the layout token).
    "SCHEDULER_TORCH_ALLOCATOR",
    "SCHEDULER_TORCH_LP_ITERS",
    "SCHEDULER_TORCH_LP_TAU",
    "SCHEDULER_TORCH_LP_TOL",
    "SCHEDULER_TORCH_LP_LIMIT",
    "SCHEDULER_TORCH_SIG_COMPRESS",
    # The inbound wire (connector/client.py ``wire_from_env``): never read
    # by a build, but a resident engine stays pinned to the ingestion
    # protocol it served, as in the JAX package: the journal and k8s wires
    # are bind-identical, and a flip mid-process must not hide a violation
    # of that behind a warm engine.
    "SCHEDULER_TORCH_WIRE",
    "SCHEDULER_TORCH_MESH",
)

# Resident engines (each holds a whole host layout and its device tensors;
# a steady scheduler needs one a session shape).
CAP = 2

_scope_counter = itertools.count(1)


def _enabled() -> bool:
    """``SCHEDULER_TORCH_ENGINE_CACHE`` (default on); ``0`` builds every
    cycle's engine cold, the twin that the cache's results are held to."""
    from scheduler_tpu_torch.utils.envflags import env_bool

    return env_bool("SCHEDULER_TORCH_ENGINE_CACHE", True)


def _cache_scope(cache) -> Optional[int]:
    """The owning cache's identity token, stored on the instance itself so
    that it dies with it."""
    scope = getattr(cache, "_engine_cache_scope", None)
    if scope is None:
        scope = next(_scope_counter)
        try:
            cache._engine_cache_scope = scope
        except Exception:  # a slotted or frozen stand-in: uncacheable
            return None
    return scope


def shape_key(ssn) -> Optional[tuple]:
    """The cache key, the coarse session shape; ``None``: uncacheable (no
    nodes, an unknown node generation, or no plugin signature)."""
    if not ssn.nodes or getattr(ssn, "node_generation", -1) < 0:
        return None
    scope = _cache_scope(ssn.cache)
    if scope is None:
        return None
    vocab = next(iter(ssn.nodes.values())).vocab
    try:
        plugin_sig = ssn.plugin_config_signature()
    except Exception:
        return None
    from scheduler_tpu_torch.ops.fused import _session_device
    from scheduler_tpu_torch.ops.mesh import topology_key

    # The mesh TOPOLOGY, not only the spec string (``auto`` resolves to
    # whatever devices the list holds): a resident's blocks are placed for
    # one topology.
    return (
        scope,
        len(ssn.nodes),
        len(ssn.queues),
        vocab.size,
        plugin_sig,
        str(_session_device(ssn)),
        tuple((k, os.environ.get(k)) for k in _ENV_KEYS),
        topology_key(),
    )


def layout_token(ssn, jobs) -> Optional[tuple]:
    """Fingerprint of everything job- and queue-side that the engine's
    layout derives from.  Jobs without pending tasks are left out (the
    build drops them), so churn confined to placed jobs (completions,
    deletions that free capacity) keeps the token and takes the delta path.
    A job contributes its store's row count, structural generation and dead
    rows, a content hash of its status and volume-ready columns, its
    priority, gang floor, queue and creation time (the FIFO tiebreak).  The
    node specs are pinned by the node generation; the dynamic node state is
    refreshed on a hit, not fingerprinted."""
    from scheduler_tpu_torch.api.types import TaskStatus

    per_job = []
    try:
        for job in jobs:
            if job.status_count(TaskStatus.PENDING) == 0:
                continue
            st = job.store
            per_job.append((
                job.uid, st.n, st.gen, st.dead,
                hash(st.status[: st.n].tobytes()),
                hash(st.volume_ready[: st.n].tobytes()),
                int(job.priority), int(job.min_available), job.queue,
                job.creation_timestamp,
            ))
        queues = tuple(
            (uid, getattr(q, "weight", None), q.creation_timestamp)
            for uid, q in sorted(ssn.queues.items())
        )
    except Exception:  # bare stand-in jobs or queues: uncacheable
        return None
    # The request tables hold scaled request rows: pin the vocabulary's
    # columns and thresholds, not only its width.
    try:
        vocab = next(iter(ssn.nodes.values())).vocab
        vocab_fp = (vocab.names, hash(vocab.min_thresholds().tobytes()))
    except Exception:
        vocab_fp = None
    return (tuple(sorted(per_job)), queues, ssn.node_generation, vocab_fp)


class EngineCache:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.rebuilds = 0

    def get_engine(self, ssn, jobs, eager_dispatch: bool = False) -> Tuple[object, str]:
        """A ``FusedAllocator`` for this session through the cache:
        ``(engine, status)`` with status ``"hit"`` (the resident engine
        refreshed), ``"rebuild"`` (a resident under the key, but the layout
        moved: built cold in its place), ``"miss"`` (no resident) or
        ``"off"`` (the cache is off or the session uncacheable).  With
        ``eager_dispatch`` a hit starts the engine's run before the rebind
        (``FusedAllocator.update``)."""
        from scheduler_tpu_torch.ops.fused import FusedAllocator, _session_device

        device = _session_device(ssn)
        if not _enabled():
            return FusedAllocator(ssn, jobs, device=device), "off"
        key = shape_key(ssn)
        token = layout_token(ssn, jobs) if key is not None else None
        if key is None or token is None:
            return FusedAllocator(ssn, jobs, device=device), "off"
        with self._lock:
            # Popped while in use; it returns when the session closes.
            engine = self._entries.pop(key, None)
        if engine is None:
            engine = FusedAllocator(ssn, jobs, device=device)
            engine._layout_token = token
            status = "miss"
        else:
            status = engine.update(ssn, jobs, token, eager_dispatch=eager_dispatch)
        engine._cache_key = key
        with self._lock:
            if status == "hit":
                self.hits += 1
            elif status == "rebuild":
                self.rebuilds += 1
            else:
                self.misses += 1
        lent = getattr(ssn, "_engine_cache_lent", None)
        if lent is None:
            ssn._engine_cache_lent = lent = []
        lent.append(engine)
        return engine, status

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "rebuilds": self.rebuilds, "entries": len(self._entries)}

    def reset_counters(self) -> dict:
        """Snapshot and zero the counters (per-cycle accounting)."""
        with self._lock:
            snap = {"hits": self.hits, "misses": self.misses, "rebuilds": self.rebuilds}
            self.hits = self.misses = self.rebuilds = 0
            return snap

    def release_session(self, ssn) -> None:
        """Return the session's engines to the cache, each first dropping
        its references into the closing session (``FusedAllocator.release``):
        a resident engine outlives its session but must not keep the
        session's job clones, tasks or cache alive."""
        lent = getattr(ssn, "_engine_cache_lent", None)
        if not lent:
            return
        ssn._engine_cache_lent = []
        for engine in lent:
            engine.release()
            key = getattr(engine, "_cache_key", None)
            if key is None or not _enabled():
                continue
            with self._lock:
                self._entries[key] = engine
                self._entries.move_to_end(key)
                while len(self._entries) > CAP:
                    self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_GLOBAL = EngineCache()


def get_engine(ssn, jobs, eager_dispatch: bool = False) -> Tuple[object, str]:
    return _GLOBAL.get_engine(ssn, jobs, eager_dispatch=eager_dispatch)


def stats() -> dict:
    return _GLOBAL.stats()


def reset_counters() -> dict:
    return _GLOBAL.reset_counters()


def release_session(ssn) -> None:
    return _GLOBAL.release_session(ssn)


def clear() -> None:
    return _GLOBAL.clear()
