from repro_torch.sharding.partition import (batch_sharding, batch_spec,
                                            cache_shardings,
                                            param_shardings, placements,
                                            shard_shape, spec_report)

__all__ = ["batch_sharding", "batch_spec", "cache_shardings",
           "param_shardings", "placements", "shard_shape", "spec_report"]
