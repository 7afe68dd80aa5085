from repro_torch.data.pipeline import DataConfig, SyntheticLM, TokenFileDataset

__all__ = ["DataConfig", "SyntheticLM", "TokenFileDataset"]
