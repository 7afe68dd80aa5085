from repro_torch.roofline.analysis import (collective_bytes_per_device,
                                           model_flops, roofline_terms)
from repro_torch.roofline.chips import H100_SXM, TPU_V5E, Chip

__all__ = ["Chip", "H100_SXM", "TPU_V5E", "collective_bytes_per_device",
           "model_flops", "roofline_terms"]
