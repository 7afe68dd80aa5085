"""repro_torch.serve — continuous-batching serving over LMB-paged KV."""

from repro_torch.serve.engine import (EngineConfig, Request, ServeEngine,
                                      SubmitSpec)
from repro_torch.serve.kv_cache import DecodeView, PagedKVStore

__all__ = ["EngineConfig", "Request", "ServeEngine", "SubmitSpec",
           "DecodeView", "PagedKVStore"]
