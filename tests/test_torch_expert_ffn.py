"""The held experts' grouped products (``kernels/expert_ffn.py``): the plain
version against a loop over (token, choice) pairs on the CPU, the
dispatcher's count, the pairs' sort and the kernels' row tiles, and on the
card the CUDA kernels against the plain version at K-EXAONE's decode and
prefill shapes, counted once a call."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build
from repro_torch.kernels import ops as kops
from repro_torch.kernels.expert_ffn import (LAUNCHES, expert_ffn_cuda,
                                            expert_ffn_plain, row_tile,
                                            sort_pairs, sort_pairs_cuda)


def _inputs(T, D, Fd, E, K, held, first, seed, dtype=torch.float32,
            device="cpu"):
    """Tokens, their top-K ids over E experts made local to the held ones
    (``first..first+held-1`` become 0..held-1), gates, held weights."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, D, generator=g)
    ids = torch.stack([torch.randperm(E, generator=g)[:K]
                       for _ in range(T)]) - first
    gates = torch.rand(T, K, generator=g)
    wg = torch.randn(held, D, Fd, generator=g) / D ** 0.5
    wu = torch.randn(held, D, Fd, generator=g) / D ** 0.5
    wd = torch.randn(held, Fd, D, generator=g) / Fd ** 0.5
    return (x.to(dtype).to(device), ids.to(device), gates.to(device),
            *(w.to(dtype).to(device) for w in (wg, wu, wd)))


def _pairs(x, ids, gates, wg, wu, wd):
    """Each (token, choice) pair on a held expert alone, in f32."""
    y = torch.zeros(x.shape)
    for t in range(x.shape[0]):
        for k in range(ids.shape[1]):
            e = int(ids[t, k])
            if 0 <= e < wg.shape[0]:
                h = F.silu(x[t] @ wg[e]) * (x[t] @ wu[e])
                y[t] += gates[t, k] * (h @ wd[e])
    return y


@pytest.mark.parametrize("first", [0, 4, 12])
def test_plain_sums_the_held_pairs(first):
    """Pairs on experts outside the held ones (negative or past ``held``
    once made local) add nothing; every held pair adds its gated output
    (f32 on the CPU: sums in another order, 1e-5)."""
    a = _inputs(T=9, D=16, Fd=24, E=16, K=3, held=4, first=first, seed=first)
    got = expert_ffn_plain(*a)
    torch.testing.assert_close(got, _pairs(*a), rtol=1e-5, atol=1e-5)
    assert got.dtype == torch.float32


def test_dispatcher_counts_and_runs_the_plain_version_on_the_cpu():
    a = _inputs(T=5, D=16, Fd=8, E=8, K=2, held=4, first=0, seed=1)
    n = kops.dispatch_counts()["expert_ffn"]
    assert torch.equal(kops.expert_ffn(*a), expert_ffn_plain(*a))
    assert kops.dispatch_counts()["expert_ffn"] == n + 1


def _tiles(offs, bm):
    """The kernels' walk over ``offs``: tile j of the grid -> (expert,
    first row, end row), for every tile that holds rows."""
    out, lo = [], int(offs[0])
    for e in range(len(offs) - 1):
        hi = int(offs[e + 1])
        out += [(e, r, min(hi, r + bm)) for r in range(lo, hi, bm)]
        lo = hi
    return out


@pytest.mark.parametrize("T,K,held,first", [(1, 8, 8, 0), (37, 8, 8, 3),
                                            (300, 4, 16, 0), (64, 2, 3, 5)])
def test_sorted_pairs_give_each_held_expert_its_rows(T, K, held, first):
    """``sort_pairs``: expert e's sorted rows hold exactly its pairs, in
    token order, the pairs not held after them; ``slot`` inverts
    ``order``.  The kernels' tiles over these rows, at every row tile,
    cover each held pair's row once, within the grid's ``ceil(rows / BM)
    + held`` tiles, each inside one expert."""
    _, ids, *_ = _inputs(T, D=8, Fd=8, E=held + 12, K=K, held=held,
                         first=first, seed=T)
    order, offs, slot, key = sort_pairs(ids, held)
    assert all(t.dtype == torch.int32 for t in (order, offs, slot, key))
    flat = ids.reshape(-1)
    mine = (flat >= 0) & (flat < held)
    assert int(offs[0]) == 0 and int(offs[-1]) == int(mine.sum())
    for e in range(held):
        rows = order[int(offs[e]):int(offs[e + 1])].long()
        assert torch.equal(rows, torch.nonzero(flat == e).reshape(-1))
    assert not mine[order[int(offs[-1]):].long()].any()
    assert torch.equal(slot[order.long()].long(), torch.arange(T * K))
    assert torch.equal(key.long(), torch.where(mine, flat, held))
    rows = T * min(K, held)
    for bm in (16, 128):
        tiles = _tiles(offs.tolist(), bm)
        assert len(tiles) <= -(-rows // bm) + held
        covered = sorted(r for _, r0, r1 in tiles for r in range(r0, r1))
        assert covered == list(range(int(offs[-1])))
        assert all(offs[e] <= r0 < r1 <= offs[e + 1] and r1 - r0 <= bm
                   for e, r0, r1 in tiles)


def test_row_tile_grows_with_the_call():
    assert [row_tile(T) for T in (1, 32, 64, 65, 1024, 2048)] == \
        [16, 16, 16, 128, 128, 128]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 32, 300, 1100])
def test_cuda_kernels_match_plain(cuda_device, T):
    """At K-EXAONE's widths (D 6144, d_ff 2048, 8 of 128 experts held,
    top-8): a decode batch (16-row tiles) and prompts (128-row tiles), in
    bf16.  The plain version rounds each product to bf16, the kernels keep
    f32 accumulators to the end of each product: within 2e-2 of the
    output's scale.  The same inputs give the same output bit for bit (no
    atomics), and each call counts one launch."""
    a = _inputs(T, 6144, 2048, 128, 8, 8, first=0, seed=T,
                dtype=torch.bfloat16, device=cuda_device)
    before = cuda_build.launch_counts().get(LAUNCHES, 0)
    got = expert_ffn_cuda(*a)
    want = expert_ffn_plain(*a)
    scale = want.abs().max().clamp(min=1e-3)
    assert float((got - want).abs().max() / scale) < 2e-2
    assert torch.equal(got, expert_ffn_cuda(*a))
    assert cuda_build.launch_counts()[LAUNCHES] == before + 2
    # every pair on a held expert: the most rows the call can have
    ids = torch.stack([torch.randperm(8, device=cuda_device)
                       for _ in range(T)])
    b = (a[0], ids, *a[2:])
    got = expert_ffn_cuda(*b)
    want = expert_ffn_plain(*b)
    scale = want.abs().max().clamp(min=1e-3)
    assert float((got - want).abs().max() / scale) < 2e-2
    # no pair on a held expert: zeros
    none = (a[0], torch.full_like(ids, 9), *a[2:])
    assert not expert_ffn_cuda(*none).any()


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,held,first", [(1, 8, 8, 0), (37, 8, 8, 3),
                                            (2048, 8, 8, 0), (300, 4, 128, 0)])
def test_sort_kernel_keeps_the_plain_sorts_contract(cuda_device, T, K, held,
                                                     first):
    """``expert_sort_kernel`` against :func:`sort_pairs`: the same first
    rows and keys, each expert's rows the same pairs (in the order its
    atomics chose), ``slot`` the inverse of ``order``."""
    _, ids, *_ = _inputs(T, D=8, Fd=8, E=held + 12, K=K, held=held,
                         first=first, seed=T, device=cuda_device)
    order, offs, slot, key = (t.cpu() for t in sort_pairs_cuda(ids, held))
    p_order, p_offs, _, p_key = sort_pairs(ids.cpu(), held)
    assert torch.equal(offs, p_offs) and torch.equal(key, p_key)
    for e in range(held + 1):
        lo, hi = int(offs[e]), int(offs[e + 1]) if e < held else T * K
        assert torch.equal(order[lo:hi].sort().values, p_order[lo:hi])
    assert torch.equal(slot[order.long()].long(), torch.arange(T * K))


def test_inputs_draw_distinct_experts_per_token():
    _, ids, *_ = _inputs(T=4, D=8, Fd=8, E=16, K=8, held=8, first=0, seed=0)
    assert all(len(set(r.tolist())) == 8 for r in ids)
    assert np.all(ids.numpy() < 16)
