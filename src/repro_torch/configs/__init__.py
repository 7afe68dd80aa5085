"""repro_torch.configs — architecture configs (copied from repro.configs)."""
