"""repro_torch — the LMB reproduction in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``repro`` that mirrors its tree and names:
``configs``, ``obs``, ``core`` (the LMB control plane, ``TierExecutor`` and
``LinkedBuffer``), ``qos``, ``rack``, ``kernels`` (hand-written CUDA
kernels with plain PyTorch versions beside them), ``models``, ``serve``,
``optim`` (AdamW, int8 error feedback), ``train`` (the train step,
checkpoints, fault tolerance), ``data`` and ``launch``.  It imports
torch, numpy and the standard library only — never ``jax`` and nothing
of ``repro``.

Entry points (``models.Model``, ``serve.ServeEngine``, ``launch.serve``,
``launch.train``) run on the CUDA device by default and raise when no
card is present, unless the caller passes ``device="cpu"``.
"""
