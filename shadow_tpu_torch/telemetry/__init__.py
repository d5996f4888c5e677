"""Deterministic simulation telemetry (see collector.py for the design)."""

from shadow_tpu_torch.telemetry.collector import (  # noqa: F401
    FLOWS_FILE,
    METRICS_FILE,
    TelemetryCollector,
)
from shadow_tpu_torch.telemetry.histogram import LogHistogram  # noqa: F401
