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
from repro_torch.configs.base import RWKV6, get_config, list_configs
from repro_torch.kernels import cuda_build, ops, ref
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (MAX_SPLITS,
                                                 MIN_LIVE_SHARE,
                                                 MIN_SPLIT_TOKENS,
                                                 CUDA_CORE_LAUNCHES,
                                                 MMA_LAUNCHES,
                                                 MMA_MAX_HEAD_DIM,
                                                 SPLIT_TOKENS_PER_HEAD,
                                                 paged_attention_cuda,
                                                 paged_attention_plain,
                                                 split_plan,
                                                 uses_tensor_cores)

# f32 on the CPU: both sides sum the same products in different orders
PAGED_TOL = 1e-5
FLASH_TOL = 2e-5
#: granite-34b's attention heads over its kv heads (MQA)
GRANITE_HEADS = (48, 1)

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
    (2, 2, 4, 120, 8, 8, 4),     # h2o-danube-3-4b's head_dim 120
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
    (8, 32, 16, 16, 64),     # seamless-m4t's decoder prefill (MHA)
    (1, 64, 4, 2, 120),      # h2o-danube-3-4b's head_dim 120
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


def _columns(n, per, MP):
    """The page-table columns of splits 0..n-1, in order."""
    return [c for s in range(n) for c in range(s * per, min((s + 1) * per,
                                                            MP))]


def _live_splits(length, per, T, MP):
    """A row's live splits: the kernels' ceil(min(n, MP T) / (per T))."""
    return -(-min(length, MP * T) // (per * T)) if length > 0 else 0


@pytest.mark.parametrize("B,KV,MP,T,G", [
    (8, 2, 16, 32, 6),       # qwen2-1.5b's decode batch: one page a split
    (1, 2, 16, 32, 6),       # B = 1 at max_seq_len 512
    (32, 1, 256, 32, 48),    # granite-34b's decode batch
    (32, 8, 256, 32, 12),    # command-r-plus-104b's heads at the same
    (16, 2, 13, 8, 6),       # MP not a multiple of the pages a split
    (3, 1, 1, 4, 2),         # MP = 1
    (1, 1, 4096, 16, 4),     # a table past MAX_SPLITS columns a split
    (5, 3, 7, 4, 3),
])
def test_split_plan_covers_each_column_once(B, KV, MP, T, G):
    """Split s takes columns [s * per, min((s + 1) * per, MP)), as both
    kernels read them: every column once, no split without a column, at
    most MAX_SPLITS a row; the pages a split holds come from T and G, not
    from the table's width, once the table is wide enough to give every
    SM a split; a table too small for that takes one page a split."""
    n, per = split_plan(B, KV, MP, T=T, G=G)
    assert _columns(n, per, MP) == list(range(MP))
    assert n >= 1 and per >= 1 and (n - 1) * per < MP
    assert n <= MAX_SPLITS
    wide, wider = (split_plan(B, KV, m, T=T, G=G)[1] for m in (MP, 2 * MP))
    if B * KV * MP >= MIN_LIVE_SHARE * 132 * per and MP <= MAX_SPLITS:
        assert wide == wider == -(-max(SPLIT_TOKENS_PER_HEAD * G,
                                       MIN_SPLIT_TOKENS) // T)
    if B * KV * MP < MIN_LIVE_SHARE * 132:
        assert per == max(1, -(-MP // MAX_SPLITS))


@pytest.mark.parametrize("sm_count", [132, 114, 8])
@pytest.mark.parametrize("B,KV,G,MP,T", [
    (8, 2, 6, 16, 32), (8, 2, 16, 16, 32), (1, 4, 24, 13, 8),
    (16, 2, 6, 1, 32), (32, 1, 48, 256, 32),
])
def test_split_plan_follows_the_card_and_the_head_chunks(sm_count, B, KV,
                                                         G, MP, T):
    """The plan covers every column once on any SM count; fewer SMs never
    ask for smaller splits, more query heads a kv head (more partial bytes
    a split writes) never for smaller ones, and a split never holds more
    pages than its head count and MIN_SPLIT_TOKENS ask for."""
    n, per = split_plan(B, KV, MP, T=T, G=G, sm_count=sm_count)
    assert _columns(n, per, MP) == list(range(MP))
    _, per_big = split_plan(B, KV, MP, T=T, G=G, sm_count=2 * sm_count)
    _, per_wide = split_plan(B, KV, MP, T=T, G=2 * G, sm_count=sm_count)
    assert per_big <= per <= per_wide
    assert per <= max(1, -(-max(SPLIT_TOKENS_PER_HEAD * G,
                                MIN_SPLIT_TOKENS) // T))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_plan_at_granites_decode_shape(seed):
    """granite-34b's decode batch (B 32, 48 query heads on one kv head,
    MP 256 columns of 32-token pages, rows of 17-50 live pages): the live
    splits cover every live page of every row once, and there are more of
    them than the card has SMs (each a block's work for all 48 heads of the
    kv head, one head chunk)."""
    B, KV, G, MP, T = 32, 1, 48, 256, 32
    n, per = split_plan(B, KV, MP, T=T, G=G)
    lengths = np.random.default_rng(seed).integers(16 * T + 1, 50 * T + 1,
                                                   B)
    live = 0
    for length in lengths:
        k = _live_splits(int(length), per, T, MP)
        assert k <= n
        pages = -(-int(length) // T)
        assert _columns(k, per, MP)[:pages] == list(range(pages))
        assert len(_columns(k, per, MP)) - pages < per  # the last, ragged
        live += k
    assert live * KV * -(-G // 64) >= 132


def _split_partials(q, kp, vp, table, lengths, per):
    """The split kernels' arithmetic, in f32.  Row b's live split s (s <
    ceil(min(n_b, MP T) / (per T))) takes its tokens [s per T, min((s + 1)
    per T, n_b)); per split and head: the max m, the sum l of e^(s - m)
    and acc = sum e^(s - m) v over the live tokens (m = -inf, l = 0,
    acc = 0 where none is live: all its pages unmapped).  The tensor-core
    kernel splits each 32-token tile's keys between two warps and merges
    their (m, l, acc) at the end; so does this mirror, at the tile's
    middle.  A split past a row's live ones is NaN: no kernel writes it,
    and the combine must not read it."""
    B, H, hd = q.shape
    _, T, KV, _ = kp.shape
    MP = table.shape[1]
    n = -(-MP // per)
    qg = q.reshape(B, KV, H // KV, hd)
    m = torch.full((B, H, n), float("nan"))
    l = torch.full((B, H, n), float("nan"))
    acc = torch.full((B, H, n, hd), float("nan"))

    def part(b, pos):
        cols = table[b, pos // T]
        k = kp[cols.clamp(min=0).long(), pos % T]        # [tokens, KV, hd]
        v = vp[cols.clamp(min=0).long(), pos % T]
        sc = torch.einsum("kgh,tkh->kgt", qg[b], k) / np.sqrt(hd)
        sc = sc.masked_fill(~(cols >= 0)[None, None, :], float("-inf"))
        mm = sc.amax(-1) if sc.shape[-1] else \
            torch.full(sc.shape[:-1], float("-inf"))
        e = torch.exp(sc - torch.where(torch.isfinite(mm), mm, 0.0)[..., None])
        return mm, e.sum(-1), torch.einsum("kgt,tkh->kgh", e, v)

    for b in range(B):
        n_b = int(lengths[b])
        for s in range(_live_splits(n_b, per, T, MP)):
            end = min((s + 1) * per * T, n_b, MP * T)
            pos = torch.arange(s * per * T, end)
            halves = [part(b, pos[(pos % 32 < 16) == first])
                      for first in (True, False)]
            mm = torch.maximum(halves[0][0], halves[1][0])
            base = torch.where(torch.isfinite(mm), mm, 0.0)
            w = [torch.where(torch.isfinite(h[0]), torch.exp(h[0] - base),
                             0.0) for h in halves]
            m[b, :, s] = mm.reshape(H)
            l[b, :, s] = (halves[0][1] * w[0] + halves[1][1] * w[1]).reshape(H)
            acc[b, :, s] = (halves[0][2] * w[0][..., None] + halves[1][2]
                            * w[1][..., None]).reshape(H, hd)
    return m, l, acc


def _combine(m, l, acc, lengths, per, T, MP):
    """The combine kernel: log-sum-exp over row b's live splits only,
    splits with no live token skipped, zeros where every split is
    empty."""
    n = torch.tensor([_live_splits(int(x), per, T, MP) for x in lengths])
    live = torch.arange(m.shape[-1])[None, None, :] < n[:, None, None]
    m = torch.where(live, m, float("-inf"))
    M = m.amax(-1, keepdim=True)
    w = torch.where(torch.isfinite(m), torch.exp(m - M), 0.0)
    L = torch.where(w > 0, l * w, 0.0).sum(-1, keepdim=True)
    out = torch.where(w[..., None] > 0, acc * w[..., None], 0.0).sum(-2)
    return torch.where(L > 0, out / torch.where(L > 0, L, 1.0), 0.0)


@pytest.mark.parametrize("B,KV,MP,lengths", [
    # rows ending mid-split (5, 9, 19), a length-0 row, rows with every
    # page live
    (16, 2, 16, [5, 0, 9, 64, 19, 1, 0, 33, 64, 2, 40, 0, 8, 17, 3, 60]),
    # MP = 13 columns: with 2 or 3 pages a split the last split is short
    (16, 2, 13, [52, 0, 37, 5] * 4),
    # a large batch of short and empty rows
    (40, 4, 9, [0, 36, 13] * 13 + [7]),
    # lengths past the table's tokens (MP T = 64) count its tokens only
    (8, 2, 16, [3, 64, 0, 21, 50, 7, 1, 30]),
])
def test_split_combine_mirror_matches_plain(B, KV, MP, lengths):
    """Partials per live split, merged by log-sum-exp, give the plain
    version's output, at the plan's pages a split and at 2 and 3;
    unmapped pages (-1, mid-row too) hold garbage that must not leak, and
    the splits past a row's live ones (NaN here) are never read."""
    T, G, hd = 4, 3, 16
    rng = np.random.default_rng(B + MP)
    lengths = np.asarray(lengths, np.int32)
    pages = np.minimum(-(-lengths // T), MP)
    P = int(pages.sum()) + 2
    table = np.full((B, MP), -1, np.int32)
    perm = iter(rng.permutation(P - 2))
    for b in range(B):
        for i in range(pages[b]):
            table[b, i] = next(perm)
        if pages[b] > 2 and b % 3 == 0:
            table[b, 1] = -1          # an unmapped page inside a live row
    q, kp, vp, table, lens = _torch(*_paged_inputs(
        B, B, KV * G, KV, hd, P, T, lengths, table))
    kp[-2:] = 1e4
    vp[-2:] = 1e4
    want = paged_attention_plain(q, kp, vp, table, lens)
    _, plan_per = split_plan(B, KV, MP, T=T, G=G)
    for per in sorted({plan_per, 2, 3}):
        m, l, acc = _split_partials(q, kp, vp, table, lens, per)
        got = _combine(m, l, acc, lengths, per, T, MP)
        torch.testing.assert_close(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)
        written = ~torch.isnan(m)
        dead = written & torch.isinf(m)
        assert (l[dead] == 0).all() and (acc[dead] == 0).all()
        assert written.sum(-1).tolist() == [
            [_live_splits(int(n), per, T, MP)] * (KV * G) for n in lengths]
        for b in np.nonzero(lengths == 0)[0]:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
    # an unmapped page mid-row leaves a split with no live token at 1
    m, _, _ = _split_partials(q, kp, vp, table, lens, 1)
    holed = [b for b in range(B) if pages[b] > 2 and b % 3 == 0]
    assert torch.isinf(m[holed, :, 1]).all()


@pytest.mark.parametrize("dtype,hd,mma", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 120, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 136, False),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False)])
def test_paged_route_follows_dtype_and_head_dim(dtype, hd, mma):
    """bf16 up to MMA_MAX_HEAD_DIM runs on tensor cores; f32 (TF32 there)
    and wider bf16 heads on CUDA cores: a rule on the inputs, not on a
    config."""
    assert uses_tensor_cores(dtype, hd) is mma
    assert MMA_MAX_HEAD_DIM == 128


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit to a header in csrc/ renames every library, so a stale
    build is never loaded."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build._lib_path("a")
    assert cuda_build._lib_path("a") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build._lib_path("a")
    assert second != first and second.name.startswith("liba-")
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edit\n')
    assert cuda_build._lib_path("a") not in (first, second)


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


#: every registered config with attention (RWKV6 has none)
ATTENTION_ARCHS = [a for a in list_configs()
                   if get_config(a).block_type != RWKV6]


def test_attention_archs_are_all_but_rwkv6():
    assert sorted(set(list_configs()) - set(ATTENTION_ARCHS)) == \
        ["rwkv6-7b"]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_attention_kernels_take_every_registered_head_dim(arch):
    """The wrappers' head_dim rule, run on every registered config that
    has attention, at full width and reduced: a config the kernels could
    not take fails here, not first on the card."""
    cfg = get_config(arch)
    for c in (cfg, cfg.reduced()):
        assert cuda_build.head_dim_ok(c.head_dim_), (arch, c.head_dim_)


@pytest.mark.parametrize("hd,ok", [
    (16, True), (24, True), (120, True), (128, True), (136, True),
    (256, True), (8, False), (12, False), (100, False), (130, False),
    (264, False)])
def test_head_dim_rule(hd, ok):
    """Multiples of 8 from 16 to 256 (whole 16-byte bf16 chunks), as both
    wrappers' message states; the reference takes any head_dim."""
    assert cuda_build.head_dim_ok(hd) is ok
    assert cuda_build.HEAD_DIM_RULE == "16..256, a multiple of 8"


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


#: every head_dim ``cuda_build.head_dim_ok`` admits
HEAD_DIMS = tuple(range(16, 257, 8))


def test_swept_head_dims_are_the_rule():
    assert HEAD_DIMS == tuple(d for d in range(300)
                              if cuda_build.head_dim_ok(d))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(cuda_device, dtype, tol, hd):
    """On the card: both kernels against their plain versions (bf16 is
    looser: both round p to bf16, the paged plain version after the
    softmax's division and the kernels before it; the flash kernel rounds
    p to bf16 and its plain version does not), at every head_dim the rule
    admits: paged at B 3, 2 KV heads of
    2 query heads, T 8, MP 5 on a row of length 0, a row ending mid-page
    before three unmapped columns of garbage pages and a row using every
    column; flash causal at S 70 (a ragged tail).  In the hd 128 case,
    once per dtype, the sets that do not sweep head_dim: paged on the
    split plan's edges (rows ending inside a split of
    two pages, trailing empty splits, every page live, MP = 13 over 7
    splits, B = 1 at 16 pages), at head_dim 120 on length 0, lengths on
    a page boundary and unmapped pages holding garbage, at granite's
    48 over 1 and command-r-plus's 96 over 8 heads, and at both at their
    decode batch (B 32, T 32, MP 256, rows of 512-1,600 tokens: granite's
    MQA is what the tensor-core kernel is for), each counted under its
    route (bf16 on tensor cores, f32 on CUDA cores); flash on S off its
    tiles, windows across tile edges, B = 2, each head_dim route (120 in
    the 128 instantiation), a non-causal case and h2o-danube-3-4b's
    prefill (32 over 8 heads, head_dim 120, window 4096) at S 256 and
    4,200, where the window cuts."""
    q, kp, vp, table, lens = (t.to(cuda_device) for t in _torch(
        *_paged_inputs(hd, 3, 4, 2, hd, 9, 8, [0, 13, 40],
                       [[-1] * 5, [6, 0, -1, -1, -1], [2, 5, 1, 4, 3]])))
    kp[7:] = 1e4                           # never mapped: must not leak
    vp[7:] = -1e4
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = paged_attention_cuda(q, kp, vp, table, lens)
    torch.testing.assert_close(
        got.float(), paged_attention_plain(q, kp, vp, table, lens).float(),
        rtol=tol, atol=tol)
    assert not got[0].any()
    g = torch.Generator(device=cuda_device).manual_seed(hd)
    q, k, v = (torch.randn(1, 70, h, hd, generator=g,
                           device=cuda_device).to(dtype) for h in (4, 2, 2))
    got = flash_attention_cuda(q, k, v)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v).float(), rtol=tol,
        atol=tol)
    if hd != 128:
        return
    for seed, (B, MP, T, lengths) in enumerate((
            (3, 4, 8, None),
            (16, 16, 8, [128, 9, 0, 1] * 3 + [120, 23, 16, 2]),
            (16, 13, 8, [104, 37, 0, 70] * 4),
            (1, 16, 32, [512]), (1, 16, 32, [301]))):
        if lengths is None:
            lengths, table = _random_table(5, B, 16, T, MP)
        else:
            pages = [-(-n // T) for n in lengths]
            table = np.full((B, MP), -1, np.int32)
            perm = iter(range(sum(pages)))
            for b in range(B):
                for i in range(pages[b]):
                    table[b, i] = next(perm)
        P = int(table.max()) + 3
        q, kp, vp, table, lens = (t.to(cuda_device) for t in _torch(
            *_paged_inputs(seed, B, 12, 2, 128, P, T, lengths, table)))
        kp[-2:] = 1e4
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        torch.testing.assert_close(
            paged_attention_cuda(q, kp, vp, table, lens).float(),
            paged_attention_plain(q, kp, vp, table, lens).float(),
            rtol=tol, atol=tol)
    for seed, (H, KV, hd, lengths, table) in enumerate((
            (8, 2, 120, [0, 9], [[-1, -1, -1], [0, 1, 2]]),
            (8, 2, 120, [8, 16], [[3, 4, -1], [5, 6, -1]]),
            (8, 2, 120, [16, 1, 0, 7], [[0, 1, 2], [4, -1, -1],
                                        [-1, -1, -1], [5, 6, -1]]),
            (32, 8, 120, [23, 5], [[1, 2, 3], [0, -1, -1]]),
            (48, 1, 128, [23, 5], [[1, 2, 3], [0, -1, -1]]),
            (96, 8, 128, [23, 5], [[1, 2, 3], [0, -1, -1]]))):
        q, kp, vp, table, lens = (t.to(cuda_device) for t in _torch(
            *_paged_inputs(seed, len(lengths), H, KV, hd, 9, 8, lengths,
                           table)))
        kp[7:] = 1e4                       # never mapped: must not leak
        vp[7:] = -1e4
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        got = paged_attention_cuda(q, kp, vp, table, lens)
        torch.testing.assert_close(
            got.float(), paged_attention_plain(q, kp, vp, table,
                                               lens).float(),
            rtol=tol, atol=tol)
        assert not got[lens == 0].any()
    # granite-34b's MQA decode batch (48 heads on one kv head) and
    # command-r-plus-104b's 12 heads a kv head: B 32, T 32, MP 256, rows of
    # 512-1,600 tokens; bf16 takes the tensor-core kernel, f32 the other
    route = MMA_LAUNCHES if dtype == torch.bfloat16 else CUDA_CORE_LAUNCHES
    for seed, (H, KV) in enumerate((GRANITE_HEADS, (96, 8))):
        rng = np.random.default_rng(seed)
        lengths = rng.integers(512, 1601, 32)
        pages = -(-lengths // 32)
        table = np.full((32, 256), -1, np.int32)
        perm = iter(rng.permutation(int(pages.sum())))
        for b in range(32):
            for i in range(pages[b]):
                table[b, i] = next(perm)
        q, kp, vp, table, lens = (t.to(cuda_device) for t in _torch(
            *_paged_inputs(seed, 32, H, KV, 128, int(pages.sum()) + 2, 32,
                           lengths, table)))
        kp[-2:] = 1e4                      # never mapped: must not leak
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        before = cuda_build.launch_counts().get(route, 0)
        got = paged_attention_cuda(q, kp, vp, table, lens)
        assert cuda_build.launch_counts().get(route, 0) == before + 1
        torch.testing.assert_close(
            got.float(), paged_attention_plain(q, kp, vp, table,
                                               lens).float(),
            rtol=tol, atol=tol)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for B, S, H, KV, hd, window, causal in (
            (1, 100, 12, 2, 128, None, True), (1, 100, 12, 2, 128, 24, True),
            (2, 70, 12, 2, 128, 40, True), (1, 256, 12, 2, 128, 100, True),
            (2, 100, 4, 1, 16, 24, True), (1, 64, 8, 8, 64, 16, True),
            (1, 100, 4, 2, 32, None, True), (1, 100, 4, 2, 96, 50, True),
            (1, 90, 4, 1, 144, None, True), (1, 100, 4, 1, 256, None, True),
            (1, 100, 4, 2, 64, None, False), (8, 32, 16, 16, 64, None, True),
            (1, 100, 4, 2, 120, None, True), (2, 70, 4, 1, 120, 40, True),
            (1, 256, 32, 8, 120, 4096, True),
            (1, 4200, 32, 8, 120, 4096, True)):
        q = torch.randn(B, S, H, hd, generator=g, device=cuda_device)
        k = torch.randn(B, S, KV, hd, generator=g, device=cuda_device)
        v = torch.randn(B, S, KV, hd, generator=g, device=cuda_device)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        torch.testing.assert_close(
            flash_attention_cuda(q, k, v, causal=causal,
                                 window=window).float(),
            flash_attention_plain(q, k, v, causal=causal,
                                  window=window).float(),
            rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_misaligned_bf16_views(cuda_device):
    """The bf16 kernels read 16-byte vectors: a view that starts off a
    16-byte boundary is refused before any launch, and the context stays
    usable."""
    def off_by_one(*shape):
        n = int(np.prod(shape))
        t = torch.zeros(n + 1, dtype=torch.bfloat16,
                        device=cuda_device)[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 != 0
        return t

    q = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16, device=cuda_device)
    k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16, device=cuda_device)
    for args in ((off_by_one(1, 8, 4, 16), k, k),
                 (q, off_by_one(1, 8, 2, 16), k),
                 (q, k, off_by_one(1, 8, 2, 16))):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_cuda(*args)
    pool = off_by_one(3, 4, 2, 16)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention_cuda(
            torch.zeros(1, 4, 16, dtype=torch.bfloat16, device=cuda_device),
            pool, pool, torch.zeros(1, 2, dtype=torch.int32,
                                    device=cuda_device),
            torch.ones(1, dtype=torch.int32, device=cuda_device))
    assert torch.isfinite(flash_attention_cuda(q, k, k).float()).all()
