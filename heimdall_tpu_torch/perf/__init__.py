from heimdall_tpu_torch.perf.metrics import (
    SlidingWindow,
    MetricCounter,
    Timer,
    ThroughputMeter,
    MetricsRegistry,
)
from heimdall_tpu_torch.perf.profiling import (
    Measurement,
    MetricType,
    ProfilingSession,
    ProfilingManager,
    measure_time,
    measure_throughput,
)
from heimdall_tpu_torch.perf.reports import Report, ReportFormat
