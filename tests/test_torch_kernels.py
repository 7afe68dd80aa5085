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
from repro_torch.kernels.paged_attention import (MAX_G,
                                                 paged_attention_cuda,
                                                 paged_attention_plain,
                                                 split_plan)

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


@pytest.mark.parametrize("B,KV,MP", [
    (8, 2, 16),      # the decode batch: one page per split, 256 blocks
    (1, 2, 16),      # B = 1 at max_seq_len 512
    (16, 2, 16),     # two pages per split
    (16, 2, 13),     # MP not a multiple of the split count
    (3, 1, 1),       # MP = 1
    (64, 8, 64),     # a grid full without splitting
    (1, 1, 512),     # a long page table
    (5, 3, 7),
])
def test_split_plan_covers_each_column_once(B, KV, MP):
    """Split s takes columns [s * per, min((s + 1) * per, MP)), as the
    kernel reads them: every column once, no split without a column."""
    n, per = split_plan(B, KV, MP)
    cols = [c for s in range(n) for c in range(s * per, min((s + 1) * per,
                                                            MP))]
    assert cols == list(range(MP))
    assert n >= 1 and per >= 1 and (n - 1) * per < MP
    if B * KV * MP <= 132:       # spreading over the SMs wins: 1 page each
        assert (n, per) == (MP, 1)


@pytest.mark.parametrize("sm_count", [132, 114, 8])
@pytest.mark.parametrize("B,KV,G,MP", [
    (8, 2, 6, 16), (8, 2, 16, 16), (1, 4, 24, 13), (16, 2, 6, 1),
    (3, 1, 9, 64),
])
def test_split_plan_follows_the_card_and_the_head_chunks(sm_count, B, KV,
                                                         G, MP):
    """The plan covers every column once on any SM count, and counts the
    kernel's head chunks (MAX_G query heads a block) in its grid: more
    chunks or fewer SMs never ask for more splits."""
    n, per = split_plan(B, KV, MP, G=G, sm_count=sm_count)
    cols = [c for s in range(n) for c in range(s * per, min((s + 1) * per,
                                                            MP))]
    assert cols == list(range(MP))
    assert (n, per) == split_plan(B, KV * -(-G // MAX_G), MP,
                                  sm_count=sm_count)
    n_wide, _ = split_plan(B, KV, MP, G=1, sm_count=sm_count)
    n_big, _ = split_plan(B, KV, MP, G=G, sm_count=2 * sm_count)
    assert n <= n_wide and n <= n_big
    if B * KV * -(-G // MAX_G) * MP <= sm_count:
        assert (n, per) == (MP, 1)


def _split_partials(q, kp, vp, table, lengths, n, per):
    """The split kernel's arithmetic, in f32: per split s and head, the
    max m, the sum l of e^(s - m) and acc = sum e^(s - m) v over the live
    tokens of its columns; m = -inf, l = 0, acc = 0 where none is live."""
    B, H, hd = q.shape
    _, T, KV, _ = kp.shape
    MP = table.shape[1]
    qg = q.reshape(B, KV, H // KV, hd)
    ms, ls, accs = [], [], []
    for s in range(n):
        c0, c1 = s * per, min((s + 1) * per, MP)
        cols = table[:, c0:c1]
        k = kp[cols.clamp(min=0).long()].reshape(B, -1, KV, hd)
        v = vp[cols.clamp(min=0).long()].reshape(B, -1, KV, hd)
        pos = torch.arange(c0 * T, c1 * T)[None, :]
        valid = (pos < lengths[:, None]) & \
            torch.repeat_interleave(cols >= 0, T, dim=1)
        sc = torch.einsum("bkgh,bskh->bkgs", qg, k) / np.sqrt(hd)
        sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
        m = sc.amax(-1)
        e = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m.reshape(B, H))
        ls.append(e.sum(-1).reshape(B, H))
        accs.append(torch.einsum("bkgs,bskh->bkgh", e, v).reshape(B, H, hd))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def _combine(m, l, acc):
    """The combine kernel: log-sum-exp over splits, empty splits skipped,
    zeros where every split is empty."""
    M = m.amax(-1, keepdim=True)
    w = torch.where(torch.isfinite(m), torch.exp(m - M), 0.0)
    L = (l * w).sum(-1, keepdim=True)
    out = (acc * w[..., None]).sum(-2)
    return torch.where(L > 0, out / torch.where(L > 0, L, 1.0), 0.0)


@pytest.mark.parametrize("B,KV,MP,lengths", [
    # 8 splits of 2 pages: rows ending mid-split (5, 9, 19), a length-0 row,
    # trailing splits with no live token, a row with every page live
    (16, 2, 16, [5, 0, 9, 64, 19, 1, 0, 33, 64, 2, 40, 0, 8, 17, 3, 60]),
    # 7 splits of 2 pages over 13 columns: the last split has one
    (16, 2, 13, [52, 0, 37, 5] * 4),
    # one split of many pages (a large batch fills the grid alone)
    (40, 4, 9, [0, 36, 13] * 13 + [7]),
    # one page per split, as on the decode path
    (8, 2, 16, [3, 64, 0, 21, 50, 7, 1, 30]),
])
def test_split_combine_mirror_matches_plain(B, KV, MP, lengths):
    """Partials per split, merged by log-sum-exp, give the plain version's
    output; unmapped pages (-1, mid-row too) hold garbage that must not
    leak."""
    T, G, hd = 4, 3, 16
    rng = np.random.default_rng(B + MP)
    lengths = np.asarray(lengths, np.int32)
    pages = -(-lengths // T)
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
    n, per = split_plan(B, KV, MP)
    m, l, acc = _split_partials(q, kp, vp, table, lens, n, per)
    got = _combine(m, l, acc)
    want = paged_attention_plain(q, kp, vp, table, lens)
    torch.testing.assert_close(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)
    dead = torch.isinf(m)
    assert dead.any() and (l[dead] == 0).all() and (acc[dead] == 0).all()
    for b in np.nonzero(lengths == 0)[0]:
        assert torch.equal(got[b], torch.zeros_like(got[b]))


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
    looser: the paged plain version rounds p to bf16 and the kernel does
    not; the flash kernel rounds p to bf16 and its plain version does
    not), at every head_dim the rule admits: paged at B 3, 2 KV heads of
    2 query heads, T 8, MP 5 on a row of length 0, a row ending mid-page
    before three unmapped columns of garbage pages and a row using every
    column; flash causal at S 70 (a ragged tail).  In the hd 128 case,
    once per dtype, the sets that do not sweep head_dim: paged on the
    split plan's edges (rows ending inside a split of
    two pages, trailing empty splits, every page live, MP = 13 over 7
    splits, B = 1 at 16 pages), at head_dim 120 on length 0, lengths on
    a page boundary and unmapped pages holding garbage, and at granite's
    48 over 1 and command-r-plus's 96 over 8 heads; flash on S off its
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
