"""Observability: the typed metric registry and its Prometheus exposition
— port of `horovod_tpu.obs` (its core).

* `obs.core` — the declared metric catalog (`METRICS`) and the
  thread-safe instruments; undeclared names are refused.
* `obs.prom` — text-format exposition (`render`) and its inverse
  (`parse_text`).
* `obs.server` — the standalone ``GET /metrics`` server
  (`start_metrics_server`, with ``POST /profile``).

Emission sites call ``obs.counter`` / ``obs.gauge`` / ``obs.histogram``
(the default registry) or a private `Registry`'s methods.
"""

from horovod_tpu_torch.obs.core import (  # noqa: F401 — the public surface
    METRICS,
    MetricSpec,
    Registry,
    UnknownMetricError,
    counter,
    counter_set,
    default_registry,
    gauge,
    histogram,
    is_declared,
    register_collector,
    reset,
    spec,
)
