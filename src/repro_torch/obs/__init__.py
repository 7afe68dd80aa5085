"""repro_torch.obs — observability: span tracing, histograms, exporters.

This package is a dependency *leaf*: it imports nothing from
``repro_torch.core`` / ``repro_torch.serve`` / ``repro_torch.qos`` (only numpy and the
stdlib), so every layer of the system can import it freely without
creating cycles.

  trace  — bounded ring-buffer span tracer (off by default; the
           disabled path is a single attribute check per call site)
  hist   — log-spaced-bucket histograms with mergeable counts and
           percentile estimation (numpy-backed)
  export — Chrome trace-event JSON (perfetto-viewable) + JSONL span
           round-trip; consumed by ``tools/lmbtrace.py``
"""

from repro_torch.obs.hist import Histogram
from repro_torch.obs.trace import (DEFAULT_RING_CAPACITY, GLOBAL_TRACER, Span,
                             SpanTracer, disable_tracing, enable_tracing)

__all__ = [
    "Histogram", "Span", "SpanTracer", "GLOBAL_TRACER",
    "DEFAULT_RING_CAPACITY", "enable_tracing", "disable_tracing",
]
