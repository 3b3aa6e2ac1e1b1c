"""repro_torch.obs: query telemetry, metrics, program spans, trace export.

The port of `repro.obs`: per-step frontier tracing inside the engine's
fixpoint (`telemetry`), a process-local metrics registry with quantile
histograms (`metrics`), and a Chrome-trace/Perfetto span exporter
(`trace`). Tracing is opt-in and exact: results and step counts are
bit-identical with it on. `from_sim` re-emits a cycle-simulator run
through the same schema.

Two cheaper instruments run beside it, with results and step counts
unchanged:

  * program spans (`span`, `enable`): the session, the fixpoint loop and
    the server mark their boundaries (`flip.query`, `flip.init`,
    `flip.fixpoint`, `flip.capture`, `flip.finalize`, `flip.pump`,
    `flip.admit`, `flip.window`, `flip.retire`). Spans are off by
    default, and then cost a flag check each. While a `torch.profiler`
    runs in the process they are recorded into its trace, on the device
    trace's clock: a traced benchmark run (`flipbench`'s ``--trace 1``)
    turns them on by starting its profiler, over exactly the profiled
    stretch. `enable(True)` records them with no profiler, and the
    loop's per-chunk `flip.chunk` and `flip.read` (`fine_span`) besides,
    into a bounded list (`recorded`, exported by
    `chrome_trace_from_spans`); `enable(False)` records none, even under
    a profiler;
  * always-on counters in the process-wide registry `PROGRAM`
    (``fixpoint.chunks``, ``.steps_enqueued``, ``.iterations``), one
    integer add per chunk.
"""
from repro_torch.obs.metrics import (PROGRAM, Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.telemetry import (DispatchTelemetry, QueryTelemetry,
                                       StepTrace, from_sim)
from repro_torch.obs.trace import (SpanRecord, TraceBuilder,
                                   chrome_trace_from_result,
                                   chrome_trace_from_spans,
                                   chrome_trace_from_telemetry, enable,
                                   fine_span, recorded, span,
                                   write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PROGRAM",
    "StepTrace", "DispatchTelemetry", "QueryTelemetry", "from_sim",
    "TraceBuilder", "chrome_trace_from_telemetry",
    "chrome_trace_from_result", "write_chrome_trace",
    "SpanRecord", "span", "fine_span", "enable", "recorded",
    "chrome_trace_from_spans",
]
