"""OpenSession / CloseSession (reference ``framework/framework.go:30-63``)."""

from __future__ import annotations

import logging
import time
from typing import List

from scheduler_tpu_torch.conf import Tier
from scheduler_tpu_torch.framework.arguments import Arguments
from scheduler_tpu_torch.framework.job_updater import JobUpdater
from scheduler_tpu_torch.framework.registry import get_plugin_builder
from scheduler_tpu_torch.framework.session import Session
from scheduler_tpu_torch.utils import metrics

logger = logging.getLogger("scheduler_tpu_torch.framework")

# Builtin plugins of the JAX package (its ``plugins/factory.py``).  A conf
# that names one of them but not a plugin this package carries must not run
# without it: skipping it would silently change the result.
REFERENCE_PLUGINS = frozenset((
    "gang", "priority", "drf", "proportion", "predicates", "nodeorder",
    "conformance", "binpack",
))


def open_session(cache, tiers: List[Tier], device=None) -> Session:
    """Snapshot the cache into a new Session and open every configured plugin.

    ``device`` is where the session's engines run (None: CUDA); tests pass
    ``"cpu"``, where every kernel wrapper runs its plain PyTorch version.

    Note on JobValid: the reference runs a JobValid sweep inside openSession
    (session.go:107-124), but at that point no plugin has registered a
    jobValidFns entry yet (plugins open *after* openSession returns,
    framework.go:31-49), so the sweep never drops anything; the real validation
    happens per-job inside each action (e.g. allocate.go:53).  We skip the dead
    sweep and keep the per-action checks.
    """
    ssn = Session(cache, tiers)
    ssn.device = device

    snapshot = cache.snapshot()
    ssn.jobs = snapshot.jobs
    for job in ssn.jobs.values():
        # EVERY job's snapshot-time status (reference openSession,
        # session.go:98-101) — the close-time JobUpdater diffs against this
        # map, and a job missing from it is pushed unconditionally; the old
        # conditions-only filter made every condition-less job pay a status
        # RPC per cycle, which at event-triggered cycle rates is a steady
        # RPC flood for unchanged statuses (docs/CHURN.md).
        if job.pod_group is not None:
            ssn.pod_group_status[job.uid] = job.pod_group.status.clone()
    ssn.nodes = snapshot.nodes
    ssn.node_generation = getattr(snapshot, "node_generation", -1)
    ssn.dirty_epoch = getattr(snapshot, "dirty_epoch", -1)
    ssn.queues = snapshot.queues

    for tier in tiers:
        for option in tier.plugins:
            if option.name in ssn.plugins:
                continue
            builder = get_plugin_builder(option.name)
            if builder is None:
                if option.name in REFERENCE_PLUGINS:
                    raise NotImplementedError(
                        f"plugin not ported: {option.name}"
                    )
                logger.error("failed to get plugin %s", option.name)
                continue
            ssn.plugins[option.name] = builder(Arguments.of(option.arguments))

    for plugin in ssn.plugins.values():
        start = time.monotonic()
        plugin.on_session_open(ssn)
        metrics.update_plugin_duration(plugin.name(), "OnSessionOpen", time.monotonic() - start)

    logger.debug(
        "open session %s with %d jobs and %d queues", ssn.uid, len(ssn.jobs), len(ssn.queues)
    )
    return ssn


def close_session(ssn: Session) -> None:
    """Plugin close hooks + job status push-back (framework.go:55-63)."""
    for plugin in ssn.plugins.values():
        start = time.monotonic()
        plugin.on_session_close(ssn)
        metrics.update_plugin_duration(plugin.name(), "OnSessionClose", time.monotonic() - start)

    JobUpdater(ssn).update_all()

    # A cached engine outlives its session but must not keep the session's
    # object graph alive (ops/engine_cache.py).
    from scheduler_tpu_torch.ops import engine_cache

    engine_cache.release_session(ssn)

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.queues = {}
    ssn.plugins = {}
    ssn.event_handlers = []
    logger.debug("close session %s", ssn.uid)
