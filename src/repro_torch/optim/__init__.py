from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import ef_compress_tree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "ef_compress_tree"]
