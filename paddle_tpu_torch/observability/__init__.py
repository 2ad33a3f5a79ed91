"""paddle_tpu_torch.observability — tracing, metrics, the flight recorder
and the executables' profile.

Counterpart of paddle_tpu/observability/__init__.py, exporting what the
port has:

* `trace` — request-scoped spans with contextvars scopes, wire
  contexts, torch.profiler / NVTX annotation and Chrome export;
* `metrics` — the registry of counters, gauges and log-bucketed
  histograms with Prometheus exposition;
* `recorder` — the flight-recorder ring flushed into crash dumps;
* `profile` — the port's counterpart of `jax.jit`: one captured CUDA
  graph per signature (`profiled_graph`), the CompileLedger with
  recompile forensics, runtime attribution and MFU, the memory ledger;
* `slo` — burn-rate objectives over windowed views of the registry
  (`SloEngine`, the alerts the fleet's autoscaler scales on);
* `health` — the composed verdict `/healthz` serves (`HealthScorer`,
  and `router_pair_factor` for a fleet router's HA pair).
"""
from paddle_tpu_torch.observability import (  # noqa: F401
    health, metrics, profile, recorder, slo, trace,
)
from paddle_tpu_torch.observability.health import (  # noqa: F401
    HealthScorer,
)
from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    Histogram, MetricsRegistry, registry,
)
from paddle_tpu_torch.observability.profile import (  # noqa: F401
    CompileLedger, MemoryLedger, attribution, compile_ledger,
    disable_capture, executable_stats, memory_ledger, observe_run,
    profile_snapshot, profiled_graph, profiled_jit,
)
from paddle_tpu_torch.observability.recorder import (  # noqa: F401
    FlightRecorder, default_dump_path, flight_recorder,
)
from paddle_tpu_torch.observability.slo import (  # noqa: F401
    BurnRule, Selector, SloEngine, SloSpec, WindowedView,
    default_serving_specs,
)
from paddle_tpu_torch.observability.trace import (  # noqa: F401
    Span, SpanContext, Tracer, attach, context_from_dict,
    context_to_dict, current_context, export_chrome_trace, get_tracer,
    is_enabled, set_enabled, span, start_span,
)
