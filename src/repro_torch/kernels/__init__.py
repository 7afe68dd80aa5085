"""Hand-written CUDA kernels for the hot spots, ported from Pallas.

  flash_attention — blocked online-softmax attention (causal/SWA/GQA)
  paged_attention — decode attention through a page table (the LMB data
                    path)
  rwkv6_scan      — the WKV6 recurrence (RWKV6 prefill)

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C interface,
built by ``cuda_build`` at first use), ``<name>.py`` (its plain PyTorch
version and the wrapper that launches it), ``ops.py`` (dispatchers the
model calls) and ``ref.py`` (plain oracles, ``ssd_ref`` among them: the
SSD scan has no kernel, in the reference either).
"""
