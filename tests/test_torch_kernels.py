"""The port's kernels against the JAX reference.

The same numpy inputs, made from a seed, go through the JAX functions and
the port's plain versions on the CPU.  The Pallas paged kernel does not run
on this JAX (``pltpu.TPUMemorySpace`` is gone), so the paged plain version
is held against ``paged_attention_xla`` and ``paged_attention_ref``; the
flash plain version against ``flash_attention(..., interpret=True)`` and
``flash_attention_ref``.  Tests marked ``cuda`` hold the CUDA kernels
against their plain versions and skip without a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_attention_xla
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)

# f32 on the CPU: both sides sum the same products in different orders
PAGED_TOL = 1e-5
FLASH_TOL = 2e-5

# one compile per shape instead of one per eager op
_xla = jax.jit(paged_attention_xla, static_argnames=("scale_override",))
_jpref = jax.jit(jref.paged_attention_ref)


def _paged_inputs(seed, B, H, KV, hd, P, T, lengths, table):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, T, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, T, KV, hd)).astype(np.float32)
    return (q, kp, vp, np.asarray(table, np.int32),
            np.asarray(lengths, np.int32))


def _random_table(seed, B, P, T, MP):
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(1, MP * T + 1, B)
    table = np.full((B, MP), -1, np.int32)
    perm = iter(rng.permutation(P))
    for b in range(B):
        for i in range(-(-int(lengths[b]) // T)):
            table[b, i] = next(perm)
    return lengths, table


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _check_paged(inputs, scale_override=None):
    q, kp, vp, table, lengths = inputs
    got = paged_attention_plain(*_torch(q, kp, vp, table, lengths),
                                scale_override=scale_override).numpy()
    xla = np.asarray(_xla(
        *(jnp.asarray(a) for a in inputs), scale_override=scale_override))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, xla, rtol=PAGED_TOL, atol=PAGED_TOL)
    if scale_override is None:
        oracle = np.asarray(_jpref(*(jnp.asarray(a) for a in inputs)))
        np.testing.assert_allclose(got, oracle, rtol=PAGED_TOL,
                                   atol=PAGED_TOL)
        mine = ref.paged_attention_ref(*_torch(*inputs)).numpy()
        np.testing.assert_allclose(mine, oracle, rtol=PAGED_TOL,
                                   atol=PAGED_TOL)
    return got


@pytest.mark.parametrize("B,KV,G,hd,P,T,MP", [
    (2, 1, 1, 16, 8, 8, 4),      # MQA, one head per group
    (3, 1, 4, 32, 16, 4, 5),     # G = 4 (the reduced qwen2 geometry)
    (2, 2, 6, 16, 12, 8, 4),     # G = 6, KV = 2 (full-width qwen2)
    (4, 2, 4, 64, 16, 16, 3),
    (2, 2, 1, 128, 6, 4, 3),     # MHA at full head_dim
])
def test_paged_plain_matches_jax(B, KV, G, hd, P, T, MP):
    lengths, table = _random_table(B * 10 + G, B, P, T, MP)
    _check_paged(_paged_inputs(B + KV, B, KV * G, KV, hd, P, T, lengths,
                               table))


@pytest.mark.parametrize("lengths,table", [
    ([0, 9], [[-1, -1, -1], [0, 1, 2]]),        # length 0 beside a live row
    ([8, 12], [[3, 4, -1], [5, 6, 7]]),         # lengths on page boundaries
    ([0, 4], [[-1, -1, -1], [2, -1, -1]]),      # all-unmapped fresh slot
    ([16, 1, 0, 7], [[0, 1, 2], [4, -1, -1],    # mixed batch
                     [-1, -1, -1], [5, 6, -1]]),
])
def test_paged_plain_edge_geometry(lengths, table):
    B = len(lengths)
    got = _check_paged(_paged_inputs(7, B, 4, 2, 16, 8, 4, lengths, table))
    for b, n in enumerate(lengths):
        if n == 0:
            assert np.array_equal(got[b], np.zeros_like(got[b]))


def test_paged_plain_ignores_unmapped_page_content():
    """Garbage in pages the table does not map must not leak."""
    inputs = _paged_inputs(4, 1, 2, 2, 16, 4, 4, [3], [[2, -1, -1]])
    q, kp, vp, table, lengths = inputs
    out1 = _check_paged(inputs)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 999.0
    vp2[0] = 999.0
    kp2[3] = -999.0
    out2 = _check_paged((q, kp2, vp2, table, lengths))
    np.testing.assert_array_equal(out1, out2)


def test_paged_plain_scale_override_zero():
    """``scale_override=0.0`` gives uniform weights over the valid
    prefix (a falsy 0.0 must not fall back to 1/sqrt(hd))."""
    inputs = _paged_inputs(6, 2, 4, 2, 32, 8, 8,
                           [13, 20], [[0, 1, -1, -1], [2, 3, 4, -1]])
    got = _check_paged(inputs, scale_override=0.0)
    _, _, vp, table, lengths = inputs
    expect = np.stack([
        vp[table[b][:-(-int(lengths[b]) // 8)]].reshape(-1, 2, 32)
        [:int(lengths[b])].mean(0) for b in range(2)])
    np.testing.assert_allclose(got, np.repeat(expect, 2, axis=1),
                               rtol=PAGED_TOL, atol=PAGED_TOL)


def test_paged_plain_reads_strided_pool_views():
    """The model hands per-layer views ``pool[:, l, 0]`` of the
    [P, L, 2, T, KV, hd] serving pool; the result equals the dense copy."""
    rng = np.random.default_rng(11)
    P, L, T, KV, hd = 6, 3, 4, 2, 16
    pool = torch.from_numpy(rng.standard_normal(
        (P, L, 2, T, KV, hd)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, hd)).astype(np.float32))
    table = torch.tensor([[0, 3, -1], [5, 1, 2]], dtype=torch.int32)
    lengths = torch.tensor([6, 11], dtype=torch.int32)
    kv, vv = pool[:, 1, 0], pool[:, 1, 1]
    assert not kv.is_contiguous()
    got = ops.paged_attention_decode(q, kv, vv, table, lengths)
    expect = paged_attention_plain(q, kv.contiguous(), vv.contiguous(),
                                   table, lengths)
    torch.testing.assert_close(got, expect, rtol=0, atol=0)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 16),      # MHA
    (2, 96, 8, 2, 32),       # GQA 4:1
    (1, 70, 6, 1, 16),       # MQA, S not a multiple of the block
    (1, 64, 12, 2, 128),     # full-width qwen2 heads
])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_plain_matches_jax(B, S, H, KV, hd, window):
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    got = flash_attention_plain(*_torch(q, k, v), window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    # the Pallas kernel at its default blocks (clamped to S): with a block
    # that leaves a ragged tail it returns NaN rows, see the test below
    kernel = np.asarray(jflash(jq, jk, jv, causal=True, window=window,
                               interpret=True))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                                 window=window))
    np.testing.assert_allclose(got, kernel, rtol=FLASH_TOL, atol=FLASH_TOL)
    np.testing.assert_allclose(got, oracle, rtol=FLASH_TOL, atol=FLASH_TOL)
    mine = ops.flash_attention(*_torch(q, k, v), window=window).numpy()
    np.testing.assert_array_equal(mine, got)


def test_flash_ragged_tail_is_finite_where_the_pallas_kernel_is_not():
    """A fault of the reference, routed around: with S = 70 and 32-row
    blocks the Pallas kernel (interpret mode) pads the last K block with
    NaN, and masked lanes (p = 0) still multiply it, so rows 64..69 come
    out NaN.  The port zero-fills out-of-range K/V rows; its rows equal
    the oracle everywhere and the Pallas rows wherever those are finite."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 70, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 70, 1, 16)).astype(np.float32)
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(k), block_q=32, block_k=32,
                               interpret=True))
    got = flash_attention_plain(*_torch(q, k, k)).numpy()
    bad = np.isnan(pallas).any(axis=(0, 2, 3))
    assert list(np.nonzero(bad)[0]) == list(range(64, 70))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, ~bad], pallas[:, ~bad],
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k)))
    np.testing.assert_allclose(got, oracle, rtol=FLASH_TOL, atol=FLASH_TOL)


def test_dispatchers_count_calls_and_take_the_plain_path_on_cpu():
    before = ops.dispatch_counts()
    inputs = _paged_inputs(3, 2, 4, 2, 16, 8, 4, [5, 9],
                           [[0, 1, -1], [2, 3, 4]])
    out = ops.paged_attention_decode(*_torch(*inputs))
    torch.testing.assert_close(
        out, paged_attention_plain(*_torch(*inputs)), rtol=0, atol=0)
    after = ops.dispatch_counts()
    assert after["paged_attention_decode"] == \
        before["paged_attention_decode"] + 1


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    inputs = _torch(*_paged_inputs(3, 1, 4, 2, 16, 8, 4, [5], [[0, 1, -1]]))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*inputs)
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(cuda_device, dtype, tol):
    """On the card: both kernels against their plain versions (bf16 is
    looser: the paged plain version rounds p to bf16, the kernel not)."""
    lengths, table = _random_table(5, 3, 16, 8, 4)
    q, kp, vp, table, lengths = (t.to(cuda_device) for t in _torch(
        *_paged_inputs(5, 3, 12, 2, 128, 16, 8, lengths, table)))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    torch.testing.assert_close(
        paged_attention_cuda(q, kp, vp, table, lengths).float(),
        paged_attention_plain(q, kp, vp, table, lengths).float(),
        rtol=tol, atol=tol)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(1, 100, 12, 128, generator=g, device=cuda_device)
    k = torch.randn(1, 100, 2, 128, generator=g, device=cuda_device)
    v = torch.randn(1, 100, 2, 128, generator=g, device=cuda_device)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    for window in (None, 24):
        torch.testing.assert_close(
            flash_attention_cuda(q, k, v, window=window).float(),
            flash_attention_plain(q, k, v, window=window).float(),
            rtol=tol, atol=tol)
