"""Typed telemetry registry — port of `horovod_tpu.obs.core`: the single
declaration point for every exported metric series.

Every series a process exposes over ``GET /metrics`` is declared here as
a `MetricSpec` (kind, help text, labels, histogram bucket edges), and the
instruments refuse undeclared names, so the catalog and the exposition
cannot drift. ``METRICS`` is the JAX package's table row for row (names,
kinds, help, labels, buckets): the same calls render the same bytes in
both packages (`tests/test_torch_obs.py` holds them together). The
table's section comments name the JAX package's emitters; the port emits
the serving series (`launch/serve.py`, `serving/router.py`) and
``hvt_scrapes_total`` (`obs/server.py`).

Stdlib only. Instruments are process-local and thread-safe (one
registry-wide lock; every operation under it is a dict lookup + float
add). Three kinds:

* **counter** — monotonically increasing total (``_total`` suffix by
  convention). ``counter(name, inc)`` adds; collectors that mirror a
  lifetime total kept elsewhere (a server's ``stats`` dict) use
  ``counter_set``.
* **gauge** — a value that goes up and down (``gauge(name, value)``).
* **histogram** — observations bucketed into the spec's FIXED edges
  (``histogram(name, value)``); exposition renders cumulative buckets,
  ``+Inf``, ``_sum`` and ``_count`` (prom.py owns the text format).

Registries: most processes use the module-level default (the
``obs.counter/gauge/histogram`` functions); a server keeps a private
`Registry` of its own, so several servers in one process never share
instruments. The *declarations* are global either way — any registry
refuses an undeclared name.

``register_collector(fn)``: callbacks run at collect() time, just before
a scrape renders — the hook for values that live elsewhere (queue depth,
an engine's counters) and are cheaper to read on demand than to push on
every change. Collector errors are swallowed per-collector: a broken
gauge must never take down the scrape surface.
"""


from __future__ import annotations

import dataclasses
import re
import threading

__all__ = [
    "MetricSpec", "METRICS", "UnknownMetricError", "Registry", "spec",
    "is_declared", "counter", "counter_set", "gauge", "histogram",
    "register_collector", "default_registry", "reset",
]

# Prometheus metric-name / label-name grammar.
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Shared latency edges (seconds), request-scale: 1 ms .. 60 s, log-ish.
_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Step-scale edges (seconds): training steps span ~1 ms (MNIST/CPU) to
# minutes (large accumulation on real pods).
_STEP_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0,
)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric series."""

    name: str
    kind: str                 # "counter" | "gauge" | "histogram"
    help: str
    subsystem: str            # catalog grouping (README table order)
    labels: tuple = ()
    buckets: tuple | None = None   # histogram only: ascending upper edges


_SUBSYSTEM_ORDER = (
    "supervisor", "serving", "training", "data", "obs",
)


def _decl(specs: list[MetricSpec]) -> dict[str, MetricSpec]:
    table: dict[str, MetricSpec] = {}
    for s in specs:
        if s.name in table:
            raise ValueError(f"duplicate metric declaration {s.name}")
        if not _NAME_RE.match(s.name):
            raise ValueError(f"{s.name}: not a valid metric name")
        if s.kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"{s.name}: unknown kind {s.kind!r}")
        if s.subsystem not in _SUBSYSTEM_ORDER:
            raise ValueError(
                f"{s.name}: unknown subsystem {s.subsystem!r} — add it to "
                "_SUBSYSTEM_ORDER so the catalog ordering stays deterministic"
            )
        for lb in s.labels:
            if not _LABEL_RE.match(lb):
                raise ValueError(f"{s.name}: invalid label name {lb!r}")
        if s.kind == "histogram":
            if not s.buckets:
                raise ValueError(f"{s.name}: histograms need bucket edges")
            if list(s.buckets) != sorted(set(s.buckets)):
                raise ValueError(
                    f"{s.name}: bucket edges must be strictly increasing"
                )
        elif s.buckets is not None:
            raise ValueError(f"{s.name}: only histograms take buckets")
        if s.kind == "counter" and not s.name.endswith("_total"):
            # The promtool naming lint; enforced at declaration so the
            # exposition can't ship a non-conventional counter.
            raise ValueError(f"{s.name}: counters must end in _total")
        table[s.name] = s
    return table


METRICS: dict[str, MetricSpec] = _decl([
    # --- supervisor (launch/supervisor.py /metrics) -------------------------
    MetricSpec("hvt_restarts_total", "counter",
               "Lifetime restarts the supervisor journaled (fleet "
               "relaunches, or per-member replacements in elastic mode).",
               "supervisor"),
    MetricSpec("hvt_fleet_shrinks_total", "counter",
               "Elastic generations that settled SMALLER than their "
               "predecessor (clean departures absorbed in place).",
               "supervisor"),
    MetricSpec("hvt_fleet_grows_total", "counter",
               "Elastic generations that settled LARGER than their "
               "predecessor (replacements/joiners admitted).",
               "supervisor"),
    MetricSpec("hvt_supervisor_gave_up_total", "counter",
               "Times the supervisor journaled spending its no-progress "
               "restart budget (>0 means the job needed an operator).",
               "supervisor"),
    MetricSpec("hvt_elastic_generation", "gauge",
               "Current elastic membership generation (bumps on every "
               "join/leave/death).", "supervisor"),
    MetricSpec("hvt_fleet_size", "gauge",
               "Settled world size of the current generation.",
               "supervisor"),
    MetricSpec("hvt_fleet_live_members", "gauge",
               "Members currently live on the rendezvous coordinator.",
               "supervisor"),
    MetricSpec("hvt_member_heartbeat_age_seconds", "gauge",
               "Seconds since each live member's last TCP beat "
               "(coordinator clock).", "supervisor", labels=("member",)),
    MetricSpec("hvt_flight_dumps_total", "counter",
               "Flight-record collections the supervisor journaled on "
               "hang classifications (each = one hang whose per-rank "
               "collective submission records were quarantined for "
               "`hvt-sched replay`).", "supervisor"),
    MetricSpec("hvt_policy_actions_total", "counter",
               "Supervisor policy-engine decisions journaled as "
               "policy_* events (launch/policy.py), by action "
               "(warn/evict/promote/triage) and outcome — outcome "
               "'dry-run' means the decision was journaled without "
               "acting (HVT_POLICY=dry-run).", "supervisor",
               labels=("action", "outcome")),
    MetricSpec("hvt_restart_budget_remaining", "gauge",
               "Consecutive no-progress restarts left before the "
               "supervisor gives up (resets to max_restarts on progress).",
               "supervisor"),
    MetricSpec("hvt_fleet_step_ms", "gauge",
               "Fleet-level step-time summary computed at GET /fleet "
               "aggregation from the member exporters' "
               "hvt_step_phase_ms{phase=total}: the slowest and fastest "
               "rank's step time this scrape.", "supervisor",
               labels=("stat",)),
    MetricSpec("hvt_committed_epoch", "gauge",
               "Epoch of the best committed progress the supervisor can "
               "see (elastic commit marker or checkpoint manifest).",
               "supervisor"),
    MetricSpec("hvt_committed_step", "gauge",
               "Best committed optimizer step: cumulative when the "
               "checkpoint manifest carries the stream geometry "
               "(epoch x steps_per_epoch + step), the within-epoch step "
               "otherwise.", "supervisor"),
    # --- fleetd (launch/fleetd.py GET /fleetd + /metrics) -------------------
    MetricSpec("hvt_fleetd_jobs", "gauge",
               "Jobs under the fleet scheduler, by lifecycle state "
               "(pending/running/done/failed).", "supervisor",
               labels=("state",)),
    MetricSpec("hvt_fleetd_hosts", "gauge",
               "Pool hosts by state: up (schedulable) or quarantined "
               "(declared lost, cooling down).", "supervisor",
               labels=("state",)),
    MetricSpec("hvt_fleetd_preempts_total", "counter",
               "Preemption decisions journaled: a lower-priority elastic "
               "job shrunk (clean leave, zero budget spend) to free "
               "hosts for a higher-priority one.", "supervisor"),
    MetricSpec("hvt_fleetd_regrows_total", "counter",
               "Regrow grants journaled: freed hosts handed back to a "
               "shrunken job (POST /grow -> take_grows).", "supervisor"),
    MetricSpec("hvt_fleetd_host_lost_total", "counter",
               "Host-loss events journaled: every rank on the host died "
               "together, charged to the owning job ONCE, host "
               "quarantined.", "supervisor"),
    MetricSpec("hvt_fleetd_job_size", "gauge",
               "Host units currently allocated to each job.",
               "supervisor", labels=("job",)),
    MetricSpec("hvt_fleetd_job_restart_budget_remaining", "gauge",
               "Each job's OWN remaining no-progress restart budget "
               "(scraped from its supervisor; isolation means a peer's "
               "failures never move it).", "supervisor",
               labels=("job",)),
    # --- serving (launch/serve.py /metrics) ---------------------------------
    MetricSpec("hvt_serve_requests_total", "counter",
               "HTTP requests served, by route and status code.",
               "serving", labels=("route", "code")),
    MetricSpec("hvt_serve_queue_depth", "gauge",
               "Rows waiting in the coalescing device queue (sampled at "
               "scrape time).", "serving"),
    MetricSpec("hvt_serve_device_calls_total", "counter",
               "Compiled-program dispatches (the coalescing win: "
               "rows_total / device_calls_total ~ effective batch).",
               "serving"),
    MetricSpec("hvt_serve_rows_total", "counter",
               "Request rows pushed through the device.", "serving"),
    MetricSpec("hvt_serve_request_seconds", "histogram",
               "End-to-end request latency by route.", "serving",
               labels=("route",), buckets=_LATENCY_BUCKETS),
    MetricSpec("hvt_serve_ttft_seconds", "histogram",
               "Time to first token per generate request (streaming: "
               "first chunk flushed; one-shot: the whole call — prefill "
               "and decode are one dispatch there).", "serving",
               buckets=_LATENCY_BUCKETS),
    MetricSpec("hvt_serve_tpot_seconds", "histogram",
               "Time per output token per generate request (decode "
               "tail / generated tokens).", "serving",
               buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                        0.05, 0.1, 0.25, 0.5, 1.0)),
    # --- serving: continuous batching engine (serving/engine.py) ------------
    MetricSpec("hvt_serve_admitted_total", "counter",
               "Sequences the continuous-batching scheduler admitted "
               "into a decode slot (prefill spliced into the live "
               "batch).", "serving"),
    MetricSpec("hvt_serve_retired_total", "counter",
               "Sequences retired from the live batch (eos or "
               "generation budget) — their KV blocks returned the same "
               "tick.", "serving"),
    MetricSpec("hvt_serve_rejected_total", "counter",
               "Admissions refused with 429 because the bounded wait "
               "queue was full (the allocator saying no at the door "
               "instead of OOMing mid-decode).", "serving"),
    MetricSpec("hvt_serve_live_seqs", "gauge",
               "Sequences currently holding a decode slot (sampled at "
               "scrape time).", "serving"),
    MetricSpec("hvt_serve_kv_blocks_used", "gauge",
               "Paged-KV blocks reserved by live + waiting-admitted "
               "sequences.", "serving"),
    MetricSpec("hvt_serve_kv_blocks_free", "gauge",
               "Paged-KV blocks available for admission.", "serving"),
    # --- serving: replica fleet (serving/router.py, serving/fleet.py) -------
    MetricSpec("hvt_serve_replicas", "gauge",
               "Replicas currently admitting traffic at the router "
               "(draining and dead replicas excluded).", "serving"),
    MetricSpec("hvt_serve_replica_inflight", "gauge",
               "Requests in flight per replica (the router's "
               "least-loaded dispatch key; 0 is the drain barrier).",
               "serving", labels=("replica",)),
    MetricSpec("hvt_serve_router_retries_total", "counter",
               "Requests the router re-dispatched to another replica "
               "after a connect failure (before any response bytes — "
               "mid-stream failures surface to the client).", "serving"),
    MetricSpec("hvt_serve_swaps_total", "counter",
               "Zero-downtime weight swaps completed across the fleet "
               "(drain -> swap -> readmit, journaled per replica).",
               "serving"),
    # --- training (the HVT_METRICS_PORT trainer exporter) -------------------
    MetricSpec("hvt_step_phase_ms", "gauge",
               "Live per-step phase attribution in ms (labels: total / "
               "compute / comm / input), sampled every HVT_METRICS_EVERY "
               "optimizer steps with the same isolated-reduction-program "
               "attribution bench.py uses.", "training",
               labels=("phase",)),
    MetricSpec("hvt_step_seconds", "histogram",
               "Sampled mean optimizer-step wall time over each "
               "sampling window.", "training", buckets=_STEP_BUCKETS),
    MetricSpec("hvt_examples_per_sec", "gauge",
               "Global examples/second over the last sampling window.",
               "training"),
    MetricSpec("hvt_mfu", "gauge",
               "Live model-FLOPs utilization vs the resolved per-chip "
               "peak (XLA cost-model flops; custom-call kernels "
               "under-count — bench rows stay the calibrated source).",
               "training"),
    MetricSpec("hvt_peak_flops_per_chip", "gauge",
               "The per-chip peak FLOP/s the MFU gauge divides by "
               "(HVT_PEAK_FLOPS override, TPU table, or calibrated).",
               "training"),
    MetricSpec("hvt_accum_k", "gauge",
               "Gradient-accumulation factor K of the running trainer.",
               "training"),
    MetricSpec("hvt_optimizer_steps_total", "counter",
               "Optimizer steps completed by this process's fits.",
               "training"),
    MetricSpec("hvt_step_samples_total", "counter",
               "Times the step-phase sampler ran (one per "
               "HVT_METRICS_EVERY window).", "training"),
    MetricSpec("hvt_step_skew_ms", "gauge",
               "Cross-rank skew over the last sampled window: max - "
               "median of the fleet's per-step blocked times (host "
               "seconds in the step call + drain — the waiting ranks' "
               "block IS the straggler's lead, in both dispatch "
               "regimes). Published by the SkewProbe (HVT_SKEW_PROBE) "
               "on multi-process runs with the trainer exporter on.",
               "training"),
    MetricSpec("hvt_straggler_rank", "gauge",
               "Process rank the fleet waited on over the last sampled "
               "window (the rank with the SMALLEST blocked time; "
               "meaningful when hvt_step_skew_ms is materially > 0).",
               "training"),
    MetricSpec("hvt_barrier_wait_ms", "gauge",
               "THIS rank's per-step blocked time beyond the fleet "
               "minimum over the last sampled window, ms — its implicit "
               "wait for the slowest rank (stragglers read ~0 while "
               "everyone else pays).", "training"),
    # --- data ---------------------------------------------------------------
    MetricSpec("hvt_data_retries_total", "counter",
               "Bounded-retry outcomes of the data layer's transient-"
               "read discipline (data.stream.RETRY_STATS): "
               "outcome=retried counts absorbed faults, "
               "outcome=exhausted counts reads whose whole budget was "
               "spent (the degrade/fail-fast escalations).", "data",
               labels=("outcome",)),
    MetricSpec("hvt_data_batches_served_total", "counter",
               "Batches the hvt-data dispatcher streamed to clients, "
               "per admitted job.", "data", labels=("job",)),
    MetricSpec("hvt_data_admissions_total", "counter",
               "hvt-data (job, shard) admissions — spec-carrying hellos "
               "registered (and journaled) by the dispatcher.", "data",
               labels=("job",)),
    MetricSpec("hvt_data_cursor_refusals_total", "counter",
               "StreamCursor refusals the dispatcher sent over the wire "
               "(foreign format version, wrong engine kind, mismatched "
               "geometry) — pre-seeded to 0 at startup so a zero gate "
               "can distinguish 'none' from 'series absent'.", "data"),
    MetricSpec("hvt_data_jobs", "gauge",
               "Jobs currently admitted to this hvt-data dispatcher "
               "(journal-adopted jobs count).", "data"),
    MetricSpec("hvt_data_degraded_total", "counter",
               "Times this process's service client exhausted its retry "
               "budget and degraded to rank-local feeding from the same "
               "cursor (byte-identical fallback).", "data"),
    MetricSpec("hvt_data_reattach_total", "counter",
               "Times a degraded service client re-attached to the "
               "hvt-data dispatcher at an epoch boundary.", "data"),
    # --- obs (the export surface itself) ------------------------------------
    MetricSpec("hvt_scrapes_total", "counter",
               "GET /metrics requests this exporter answered.", "obs"),
    MetricSpec("hvt_trace_spans_dropped_total", "counter",
               "Trace spans lost to a dead span writer (HVT_TRACE_DIR "
               "unwritable/torn) — the writer fails once silently to "
               "protect training, this counter makes the loss visible.",
               "obs"),
])


class UnknownMetricError(KeyError):
    """A metric was emitted that is not declared in this registry."""

    def __init__(self, name: str):
        super().__init__(
            f"{name} is not a declared metric — add a MetricSpec row to "
            "horovod_tpu_torch/obs/core.py (kind, help, subsystem, labels, "
            "buckets) so the exposition catalog stays the single source "
            "of truth"
        )


def spec(name: str) -> MetricSpec:
    try:
        return METRICS[name]
    except KeyError:
        raise UnknownMetricError(name) from None


def is_declared(name: str) -> bool:
    return name in METRICS


def _label_key(s: MetricSpec, labels: dict) -> tuple:
    if set(labels) != set(s.labels):
        raise ValueError(
            f"{s.name}: labels {sorted(labels)} do not match the declared "
            f"label set {sorted(s.labels)}"
        )
    return tuple(str(labels[lb]) for lb in s.labels)


class _Hist:
    """One histogram series: per-edge counts + sum + count."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_edges: int):
        self.counts = [0] * n_edges  # per-edge (non-cumulative) counts
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float, edges: tuple) -> None:
        for i, edge in enumerate(edges):
            if value <= edge:
                self.counts[i] += 1
                break
        self.sum += value
        self.count += 1


class Registry:
    """Process-local, thread-safe instrument store over the global
    declarations. See the module docstring for when to use a private
    instance vs the module-level default."""

    def __init__(self):
        self._lock = threading.Lock()
        # (name, label-values tuple) -> float | _Hist
        self._series: dict[tuple, object] = {}
        self._collectors: list = []

    # -- emission -----------------------------------------------------------

    def counter(self, name: str, inc: float = 1.0, **labels) -> None:
        s = spec(name)
        if s.kind != "counter":
            raise ValueError(f"{name} is a {s.kind}, not a counter")
        if inc < 0:
            raise ValueError(f"{name}: counters only go up (inc={inc})")
        key = (name, _label_key(s, labels))
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + inc

    def counter_set(self, name: str, total: float, **labels) -> None:
        """Mirror a lifetime total whose monotonic source of truth lives
        elsewhere (the restart journal, ``RETRY_STATS``) — the collector
        idiom; never mix with `counter` on the same series."""
        s = spec(name)
        if s.kind != "counter":
            raise ValueError(f"{name} is a {s.kind}, not a counter")
        key = (name, _label_key(s, labels))
        with self._lock:
            self._series[key] = float(total)

    def gauge(self, name: str, value: float, **labels) -> None:
        s = spec(name)
        if s.kind != "gauge":
            raise ValueError(f"{name} is a {s.kind}, not a gauge")
        key = (name, _label_key(s, labels))
        with self._lock:
            self._series[key] = float(value)

    def histogram(self, name: str, value: float, **labels) -> None:
        s = spec(name)
        if s.kind != "histogram":
            raise ValueError(f"{name} is a {s.kind}, not a histogram")
        key = (name, _label_key(s, labels))
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = _Hist(len(s.buckets))
            h.observe(float(value), s.buckets)

    # -- scrape side --------------------------------------------------------

    def register_collector(self, fn) -> None:
        """``fn(registry)`` runs at every `collect()`, just before a
        scrape renders — for values read on demand (queue depths, module
        counters). Exceptions are swallowed per collector. Registering
        the SAME callable again is a no-op, so long-lived emitters (the
        trainer exporter re-registers per fit) can re-assert their
        collector after a `reset()` without stacking duplicates."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> list:
        """``[(spec, [(label_values, value_or_Hist), ...]), ...]`` in
        declaration order — the exposition's input (prom.render)."""
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:
                pass  # a broken gauge must never take down the scrape
        with self._lock:
            items = list(self._series.items())
        by_name: dict[str, list] = {}
        for (name, lv), value in items:
            by_name.setdefault(name, []).append((lv, value))
        out = []
        for name, s in METRICS.items():
            if name in by_name:
                out.append((s, sorted(by_name[name], key=lambda kv: kv[0])))
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._collectors.clear()


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def counter(name: str, inc: float = 1.0, **labels) -> None:
    _DEFAULT.counter(name, inc, **labels)


def counter_set(name: str, total: float, **labels) -> None:
    _DEFAULT.counter_set(name, total, **labels)


def gauge(name: str, value: float, **labels) -> None:
    _DEFAULT.gauge(name, value, **labels)


def histogram(name: str, value: float, **labels) -> None:
    _DEFAULT.histogram(name, value, **labels)


def register_collector(fn) -> None:
    _DEFAULT.register_collector(fn)


def reset() -> None:
    """Clear the default registry (tests)."""
    _DEFAULT.reset()
