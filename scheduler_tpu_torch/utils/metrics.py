"""In-process metrics registry with Prometheus text exposition.

The reference's Prometheus collectors under namespace ``volcano``
(``pkg/scheduler/metrics/metrics.go:26-121``) that the allocate cycle
records: e2e, plugin and action latency, unschedulable tasks and jobs, job
retries.  Metric names and label sets are kept identical so dashboards
written for the reference keep working; ``render_prometheus`` gives the text
exposition.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Tuple

NAMESPACE = "volcano"

# Exponential buckets 5ms * 2^k, 10 buckets — metrics.go:41.
_LATENCY_BUCKETS_MS = [5.0 * (2 ** k) for k in range(10)]
# The microsecond-unit families (plugin/action latency) observe values in µs;
# reusing the ms-magnitude bounds verbatim would park every realistic sample
# (a 50ms action = 50000) in +Inf and make the cumulative le buckets this
# module now exports meaningless for them — scale the same shape to µs
# covering 5ms..2.56s.
_LATENCY_BUCKETS_US = [b * 1000.0 for b in _LATENCY_BUCKETS_MS]

_lock = threading.Lock()


class _Histogram:
    def __init__(self, name: str, help_text: str, buckets_ms: List[float]) -> None:
        self.name = name
        self.help = help_text
        self.buckets = buckets_ms
        self.counts: Dict[Tuple, List[int]] = defaultdict(lambda: [0] * (len(buckets_ms) + 1))
        self.sums: Dict[Tuple, float] = defaultdict(float)
        self.totals: Dict[Tuple, int] = defaultdict(int)

    def observe(self, value_ms: float, labels: Tuple = ()) -> None:
        with _lock:
            row = self.counts[labels]
            for i, b in enumerate(self.buckets):
                if value_ms <= b:
                    row[i] += 1
                    break
            else:
                row[-1] += 1
            self.sums[labels] += value_ms
            self.totals[labels] += 1


class _Counter:
    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self.values: Dict[Tuple, float] = defaultdict(float)

    def inc(self, labels: Tuple = (), by: float = 1.0) -> None:
        with _lock:
            self.values[labels] += by


class _Gauge:
    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self.values: Dict[Tuple, float] = defaultdict(float)

    def set(self, value: float, labels: Tuple = ()) -> None:
        with _lock:
            self.values[labels] = value


e2e_latency = _Histogram(
    f"{NAMESPACE}_e2e_scheduling_latency_milliseconds", "E2E scheduling latency", _LATENCY_BUCKETS_MS
)
plugin_latency = _Histogram(
    f"{NAMESPACE}_plugin_scheduling_latency_microseconds", "Plugin latency", _LATENCY_BUCKETS_US
)
action_latency = _Histogram(
    f"{NAMESPACE}_action_scheduling_latency_microseconds", "Action latency", _LATENCY_BUCKETS_US
)
unschedule_task_count = _Gauge(
    f"{NAMESPACE}_unschedule_task_count", "Unschedulable tasks per job"
)
unschedule_job_count = _Gauge(f"{NAMESPACE}_unschedule_job_count", "Unschedulable jobs")
job_retry_counts = _Counter(f"{NAMESPACE}_job_retry_counts", "Job retries")

# Label NAMES per metric family.  ``plugin_latency`` takes ("plugin",
# "event") — the reference labels the callback kind ("OnSession"/
# "OnSessionOpen"/...) as the VALUE of an ``event`` label
# (metrics.go:46-52); the old pair ("plugin", "OnSession") had leaked a
# label value into the name slot, producing exposition no strict parser
# (or PromQL group-by) could use.
_LABEL_NAMES = {
    plugin_latency.name: ("plugin", "event"),
    action_latency.name: ("action",),
    unschedule_task_count.name: ("job_id",),
    job_retry_counts.name: ("job_id",),
}


def update_e2e_duration(seconds: float) -> None:
    e2e_latency.observe(seconds * 1000.0)


def update_plugin_duration(plugin: str, on_session: str, seconds: float) -> None:
    plugin_latency.observe(seconds * 1e6, (plugin, on_session))


def update_action_duration(action: str, seconds: float) -> None:
    action_latency.observe(seconds * 1e6, (action,))


def update_unschedule_task_count(job_id: str, count: int) -> None:
    unschedule_task_count.set(count, (job_id,))


def update_unschedule_job_count(count: int) -> None:
    unschedule_job_count.set(count)


def register_job_retries(job_id: str) -> None:
    job_retry_counts.inc((job_id,))


def escape_label_value(value: str) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped or the sample line
    is unparseable (a plugin name containing ``"`` would corrupt every
    scrape after it)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_labels(metric_name: str, labels: Tuple, extra: Tuple = ()) -> str:
    """Render ``{name="value",...}`` for a sample.  ``extra`` appends
    pre-named pairs (the histogram ``le`` bucket label) after the metric's
    declared label set."""
    names = _LABEL_NAMES.get(metric_name, tuple(f"label{i}" for i in range(len(labels))))
    pairs = list(zip(names, labels)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(
        f'{n}="{escape_label_value(str(v))}"' for n, v in pairs
    )
    return "{" + inner + "}"


def _fmt_le(bound: float) -> str:
    """``le`` bound rendering: integral bounds drop the trailing ``.0``
    (the convention Prometheus clients use — ``le="5"``, not ``le="5.0"``)."""
    return str(int(bound)) if float(bound).is_integer() else repr(float(bound))


def render_prometheus() -> str:
    """Text exposition of every collector."""
    out: List[str] = []
    with _lock:
        for h in (e2e_latency, plugin_latency, action_latency):
            out.append(f"# HELP {h.name} {h.help}")
            out.append(f"# TYPE {h.name} histogram")
            for labels, total in h.totals.items():
                lbl = _fmt_labels(h.name, labels)
                # Cumulative ``le`` buckets: the stored per-bucket counts are
                # NON-cumulative (observe() increments exactly one slot), so
                # a running sum converts them; the mandatory ``+Inf`` bucket
                # equals _count.  Without these lines histogram_quantile()
                # was impossible against the daemon — _count/_sum alone
                # cannot reconstruct a distribution.
                row = h.counts[labels]
                running = 0
                for i, bound in enumerate(h.buckets):
                    running += row[i]
                    blbl = _fmt_labels(
                        h.name, labels, (("le", _fmt_le(bound)),)
                    )
                    out.append(f"{h.name}_bucket{blbl} {running}")
                inf_lbl = _fmt_labels(h.name, labels, (("le", "+Inf"),))
                out.append(f"{h.name}_bucket{inf_lbl} {total}")
                out.append(f"{h.name}_count{lbl} {total}")
                out.append(f"{h.name}_sum{lbl} {h.sums[labels]}")
        for c in (job_retry_counts,):
            out.append(f"# HELP {c.name} {c.help}")
            out.append(f"# TYPE {c.name} counter")
            for labels, v in c.values.items():
                out.append(f"{c.name}{_fmt_labels(c.name, labels)} {v}")
        for g in (unschedule_task_count, unschedule_job_count):
            out.append(f"# HELP {g.name} {g.help}")
            out.append(f"# TYPE {g.name} gauge")
            for labels, v in g.values.items():
                out.append(f"{g.name}{_fmt_labels(g.name, labels)} {v}")
    return "\n".join(out) + "\n"
