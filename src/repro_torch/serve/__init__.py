"""repro_torch.serve — continuous-batching serving over LMB-paged KV, and
the trace-driven load harness that replays seeded traffic against it."""

from repro_torch.serve.engine import (EngineConfig, Request, ServeEngine,
                                      SubmitSpec)
from repro_torch.serve.kv_cache import DecodeView, PagedKVStore
from repro_torch.serve.loadgen import (SweepReport, TenantLoad, VirtualClock,
                                       build_trace, run_sweep)

__all__ = ["EngineConfig", "Request", "ServeEngine", "SubmitSpec",
           "DecodeView", "PagedKVStore", "TenantLoad", "VirtualClock",
           "build_trace", "run_sweep", "SweepReport"]
