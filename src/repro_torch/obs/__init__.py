"""repro_torch.obs: query telemetry, metrics, and trace export.

The port of `repro.obs`: per-step frontier tracing inside the engine's
fixpoint (`telemetry`), a process-local metrics registry with quantile
histograms (`metrics`), and a Chrome-trace/Perfetto span exporter
(`trace`). Tracing is opt-in and exact: results and step counts are
bit-identical with it on. `from_sim` re-emits a cycle-simulator run
through the same schema.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.telemetry import (DispatchTelemetry, QueryTelemetry,
                                       StepTrace, from_sim)
from repro_torch.obs.trace import (TraceBuilder, chrome_trace_from_result,
                                   chrome_trace_from_telemetry,
                                   write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "StepTrace", "DispatchTelemetry", "QueryTelemetry", "from_sim",
    "TraceBuilder", "chrome_trace_from_telemetry",
    "chrome_trace_from_result", "write_chrome_trace",
]
