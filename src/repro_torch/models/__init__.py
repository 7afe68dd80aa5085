"""repro_torch.models — the model zoo (DENSE decoder-only so far)."""

from repro_torch.models.zoo import Model, build_model

__all__ = ["Model", "build_model"]
