"""Always-on cycle flight recorder: the one channel every evidence system
feeds.

Every scheduling cycle appends one bounded record (phase split, every
evidence note channel, the trigger's event batch, binds and evictions) into
a lock-guarded ring (``SCHEDULER_TORCH_OBS_RING`` entries, default 256) that
the daemon serves at ``/debug/cycles``, plus rolling serving aggregates that
``/metrics`` exports (queue depth, time-to-bind quantiles, engine-cache hit
rate from the ``engine_cache`` note, dirty rows scattered from the ``dirty``
note, events per cycle, watch relist bytes).

``utils/phases.py`` is a thin frontend over this module, so every
measurement protocol (``harness/measure.py``, ``chip_smoke.py``, the tests)
reads the same objects it always did.  ``SCHEDULER_TORCH_OBS=0`` keeps the
recorder passive: a record opens only where a protocol calls ``begin()``.

This is the port's own copy of the JAX package's ``utils/obs.py``, without
its lockset-sanitizer hooks and its static channel registry.

Threading: the CYCLE buffers (phases and notes of the cycle in flight) are
single-threaded by design: cycles run in one thread.  The RING and the
serving aggregates are read by the daemon's HTTP threads and written by
bind/evict commits on IO workers, so they sit behind ``_serving_lock``;
nothing under that lock ever acquires another lock (the cache calls in
``render_prometheus`` run after it is released).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional, Tuple

from scheduler_tpu_torch.utils import trace
from scheduler_tpu_torch.utils.envflags import env_bool, env_int

# Cycle in flight (single-threaded: no lock).
_cur: Optional[dict] = None

# Ring + serving aggregates (HTTP threads + IO workers: lock-guarded).
_serving_lock = threading.Lock()
_ring: Optional[Deque[dict]] = None
_seq = 0
_binds_total = 0
_evictions_total = 0
_binds_by_queue: Dict[str, int] = {}
_ttb_samples: Dict[str, Deque[float]] = {}
_cycles_total = 0
_events_total = 0
_outcomes: Dict[str, int] = {}
_dirty_rows_total = 0

TTB_WINDOW = 512  # bounded per-queue time-to-bind sample window


def enabled() -> bool:
    """The always-on recorder switch: ``SCHEDULER_TORCH_OBS`` (default on).
    ``0`` leaves the recorder passive (records only where a protocol opens
    one) and commits nothing to the ring."""
    return env_bool("SCHEDULER_TORCH_OBS", True)


def ring_capacity() -> int:
    return env_int("SCHEDULER_TORCH_OBS_RING", 256, minimum=8, maximum=65536)


# -- cycle capture (the phases frontend delegates here) -----------------------

def begin() -> int:
    """Open the cycle record; returns the cycle-scoped id that links the
    ring entry, the span trace file and the sampled device profile."""
    global _cur, _seq
    with _serving_lock:
        _seq += 1
        seq = _seq
        binds0, evictions0 = _binds_total, _evictions_total
    _cur = {
        "id": seq,
        "t0": time.perf_counter(),
        "ts": time.time(),
        "phases": {},
        "notes": {},
        "binds0": binds0,
        "evictions0": evictions0,
    }
    return seq


def active() -> bool:
    return _cur is not None


def add(name: str, secs: float) -> None:
    if _cur is not None:
        ph = _cur["phases"]
        ph[name] = ph.get(name, 0.0) + secs


def note(name: str, value) -> None:
    if _cur is not None:
        _cur["notes"][name] = value


def get_note(name: str):
    """The note ``name`` recorded so far in the open cycle (None if none)."""
    return _cur["notes"].get(name) if _cur is not None else None


def take_notes() -> Dict[str, object]:
    return dict(_cur["notes"]) if _cur is not None else {}


def end(extra: Optional[dict] = None) -> Dict[str, float]:
    """Close the cycle record.  Returns the {phase: seconds} dict exactly as
    ``phases.end()`` always did; when the recorder is enabled, a JSON-safe
    COPY of the record (plus ``extra`` — the scheduler loop's trigger batch
    stats) is committed to the ring and folded into the serving
    aggregates."""
    global _cur
    rec, _cur = _cur, None
    if rec is None:
        return {}
    if enabled():
        _commit(rec, extra)
    return rec["phases"]


@contextmanager
def phase(name: str):
    """Time a block into the cycle record; also a trace span when a cycle
    trace is armed (utils/trace.py) — the phase split IS the span tree's
    first level, one instrumentation point for both."""
    if _cur is None and not trace.armed():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        add(name, dt)
        trace.emit(name, t0, dt)


# -- ring commit --------------------------------------------------------------

def _jsonable(value):
    """Ring entries must serve as JSON from /debug/cycles: numpy scalars
    (kernel counters ride the note channels) convert here, ONCE at commit,
    so the HTTP handler never chokes on an exotic leaf."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(value)


def _commit(rec: dict, extra: Optional[dict]) -> None:
    global _ring, _cycles_total, _events_total, _dirty_rows_total
    entry = {
        "cycle": rec["id"],
        "ts": round(rec["ts"], 3),
        "s": round(time.perf_counter() - rec["t0"], 6),
        "phases": {k: round(float(v), 6) for k, v in rec["phases"].items()},
        "notes": _jsonable(rec["notes"]),
    }
    if extra:
        entry.update(_jsonable(extra))
    notes = entry["notes"]
    outcome = notes.get("engine_cache")
    dirty = notes.get("dirty") or {}
    rows = dirty.get("rows_scattered")
    with _serving_lock:
        entry["binds"] = _binds_total - rec["binds0"]
        entry["evictions"] = _evictions_total - rec["evictions0"]
        cap = ring_capacity()
        if _ring is None or _ring.maxlen != cap:
            _ring = deque(_ring or (), maxlen=cap)
        _ring.append(entry)
        _cycles_total += 1
        _events_total += int(entry.get("events", 0) or 0)
        if isinstance(outcome, str):
            _outcomes[outcome] = _outcomes.get(outcome, 0) + 1
        if isinstance(rows, int) and rows > 0:
            _dirty_rows_total += rows


# -- commit-seam hooks (cache layer) ------------------------------------------

def binds_committed(batches: List[Tuple[str, int, List[float]]]) -> None:
    """Called by the cache at bind commit (single, bulk and columnar paths):
    ``(queue, count, ages)`` per job batch, where ``ages`` holds
    time-to-bind samples for AT MOST the window tail of the batch — the
    commit seam stays O(window), never O(binds), so a 100k-bind flagship
    cycle pays microseconds here (the <1% overhead contract)."""
    global _binds_total
    if not batches or not enabled():
        return
    with _serving_lock:
        for queue, count, ages in batches:
            _binds_total += count
            _binds_by_queue[queue] = _binds_by_queue.get(queue, 0) + count
            if ages:
                win = _ttb_samples.get(queue)
                if win is None:
                    win = _ttb_samples[queue] = deque(maxlen=TTB_WINDOW)
                win.extend(ages[-TTB_WINDOW:])


def evictions_committed(count: int) -> None:
    global _evictions_total
    if count <= 0 or not enabled():
        return
    with _serving_lock:
        _evictions_total += count


# -- read surface -------------------------------------------------------------

def ring_snapshot() -> List[dict]:
    with _serving_lock:
        return list(_ring or ())


def serving_totals() -> dict:
    """Aggregate snapshot (tests + the exposition renderer)."""
    with _serving_lock:
        return {
            "cycles": _cycles_total,
            "events": _events_total,
            "binds": _binds_total,
            "binds_by_queue": dict(_binds_by_queue),
            "evictions": _evictions_total,
            "outcomes": dict(_outcomes),
            "dirty_rows": _dirty_rows_total,
            "ttb": {q: list(w) for q, w in _ttb_samples.items()},
        }


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def render_prometheus(cache=None) -> str:
    """The serving-era /metrics families, appended to the reference-shaped
    collectors of ``utils/metrics.py`` by the daemon handler.  ``cache``
    (optional) contributes scrape-time state: per-queue pending depth and
    pending ages, and the connector's relist-byte counters."""
    from scheduler_tpu_torch.utils.metrics import escape_label_value

    totals = serving_totals()
    ring = ring_snapshot()

    def esc(v) -> str:
        return escape_label_value(str(v))

    lines: List[str] = []

    def fam(name: str, mtype: str, help_text: str,
            rows: List[Tuple[str, float]]) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for lbl, v in rows:
            lines.append(f"{name}{lbl} {v}")

    fam("volcano_scheduler_cycles_total", "counter",
        "Scheduling cycles recorded by the flight recorder",
        [("", totals["cycles"])])
    fam("volcano_scheduler_events_total", "counter",
        "Watch events consumed by recorded cycles",
        [("", totals["events"])])
    window = [e.get("events", 0) or 0 for e in ring]
    fam("volcano_events_per_cycle", "gauge",
        "Mean watch events per cycle over the flight-recorder ring",
        [("", round(sum(window) / len(window), 4) if window else 0.0)])
    fam("volcano_engine_cache_outcomes_total", "counter",
        "Engine-cache outcome per recorded cycle",
        [('{outcome="%s"}' % esc(k), v)
         for k, v in sorted(totals["outcomes"].items())] or [])
    judged = sum(totals["outcomes"].values())
    hits = totals["outcomes"].get("hit", 0)
    fam("volcano_engine_cache_hit_ratio", "gauge",
        "Engine-cache hit fraction over recorded cycles",
        [("", round(hits / judged, 4) if judged else 0.0)])
    fam("volcano_dirty_rows_scattered_total", "counter",
        "Node rows delta-scattered by the dirty-set fast path",
        [("", totals["dirty_rows"])])
    fam("volcano_binds_total", "counter",
        "Pod binds committed by the cache, by queue",
        [('{queue="%s"}' % esc(q), v)
         for q, v in sorted(totals["binds_by_queue"].items())] or [])
    fam("volcano_evictions_total", "counter",
        "Pod evictions committed by the cache",
        [("", totals["evictions"])])
    ttb_rows: List[Tuple[str, float]] = []
    for q, samples in sorted(totals["ttb"].items()):
        vals = sorted(samples)
        for quant in (0.5, 0.99):
            ttb_rows.append((
                '{queue="%s",quantile="%s"}' % (esc(q), quant),
                round(_quantile(vals, quant), 6),
            ))
    fam("volcano_time_to_bind_seconds", "gauge",
        "Time from first-seen-pending to bind commit (windowed quantiles)",
        ttb_rows)
    fam("volcano_obs_ring_depth", "gauge",
        "Cycles currently held by the flight-recorder ring",
        [("", len(ring))])

    snap = None
    if cache is not None and hasattr(cache, "obs_serving_snapshot"):
        try:
            snap = cache.obs_serving_snapshot()
        except Exception:  # a scrape must never take the daemon down
            snap = None
    depth_rows: List[Tuple[str, float]] = []
    age_rows: List[Tuple[str, float]] = []
    if snap:
        for q, n in sorted(snap.get("queue_depth", {}).items()):
            depth_rows.append(('{queue="%s"}' % esc(q), n))
        for q, ages in sorted(snap.get("pending_ages", {}).items()):
            vals = sorted(ages)
            for quant in (0.5, 0.99):
                age_rows.append((
                    '{queue="%s",quantile="%s"}' % (esc(q), quant),
                    round(_quantile(vals, quant), 6),
                ))
    fam("volcano_queue_pending_depth", "gauge",
        "Pending (schedulable) tasks per queue at scrape time", depth_rows)
    fam("volcano_pending_age_seconds", "gauge",
        "Age of currently-pending tasks per queue (windowed scrape-time "
        "quantiles)",
        age_rows)

    relist_rows: List[Tuple[str, float]] = []
    client = cache.client() if cache is not None else None
    for r in getattr(client, "reflectors", None) or ():
        labels = 'resource="%s"' % esc(getattr(r, "kind", "?"))
        if getattr(r, "shard", None):
            # Sharded pod watches (docs/TENANT.md): one series per
            # partition — two bare resource="pod" rows would collide.
            labels += ',shard="%s"' % esc(r.shard)
        relist_rows.append(("{%s}" % labels, getattr(r, "relist_bytes", 0)))
    fam("volcano_watch_relist_bytes_total", "counter",
        "Bytes paid to LIST/relist per watched resource", relist_rows)

    return "\n".join(lines) + "\n"


def reset() -> None:
    """Test hook: drop the ring, the aggregates and any open record."""
    global _cur, _ring, _seq, _binds_total, _evictions_total
    global _cycles_total, _events_total, _dirty_rows_total
    _cur = None
    with _serving_lock:
        _ring = None
        _seq = 0
        _binds_total = 0
        _evictions_total = 0
        _binds_by_queue.clear()
        _ttb_samples.clear()
        _cycles_total = 0
        _events_total = 0
        _outcomes.clear()
        _dirty_rows_total = 0
