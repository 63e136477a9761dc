"""repro_torch.obs — the fabric flight recorder.

Strictly opt-in observability for the scheduling fabric: structured
event tracing (`Tracer`, Chrome-trace export), AutoCounter-style
sampled counters (`CounterSampler`), and scheduler self-profiling, all
behind one `FlightRecorder` attached via ``recorder.attach(fabric)``.
Core modules never import this package — they hold a duck-typed
``fabric.obs`` slot that defaults to None — so the detached hot path
allocates nothing and golden traces stay byte-identical.

See docs/observability.md for the event taxonomy and overhead
methodology.
"""

from repro_torch.obs.export import chrome_trace, export_chrome_trace
from repro_torch.obs.recorder import (COUNTER_NAMES, CounterSampler,
                                FlightRecorder, PROF_KEYS)
from repro_torch.obs.trace import KINDS, TraceEvent, Tracer

__all__ = [
    "COUNTER_NAMES", "CounterSampler", "FlightRecorder", "KINDS",
    "PROF_KEYS", "TraceEvent", "Tracer", "chrome_trace",
    "export_chrome_trace",
]
