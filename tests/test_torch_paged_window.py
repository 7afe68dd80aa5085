"""The paged decode kernel's window (``window`` tokens, 0 = none): the plain
version against attention over each row's last ``window`` keys, a mirror
of the kernels' split arithmetic with the window on the CPU, the pages a
call reads, and on the card both kernels against the plain version at
K-EXAONE's (G 8) and granite's (G 48) decode shapes, window 0 equal bit
for bit to a window no row reaches."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.paged_attention import (WINDOWED_LAUNCHES,
                                                 paged_attention_cuda,
                                                 paged_attention_plain,
                                                 pages_read, split_plan,
                                                 window_columns)

#: f32 on the CPU: the plain version and the direct softmax sum in other
#: orders
TOL = 1e-5
#: bf16 on the card: the kernels round p to bf16 before the sum, the plain
#: version after the division (as in test_torch_kernels)
BF16_TOL = 2e-2
W = 128
T = 32
#: lengths (the new token included) below, at and past the window, around
#: the 32-token page edges: the window's first key at a page's first and
#: last token and inside one
LENGTHS = [1, 31, 32, 33, 127, 128, 129, 160, 161, 191, 192, 193, 255, 300,
           417, 1000]


def _inputs(B, H, KV, hd, lengths, MP, seed, dtype=torch.float32,
            device="cpu"):
    """Rows of ``lengths`` tokens on shuffled pages of T tokens; pages no
    row maps hold garbage that must not leak."""
    rng = np.random.default_rng(seed)
    pages = [-(-n // T) for n in lengths]
    P = sum(pages) + 2
    perm = iter(rng.permutation(P - 2))
    table = np.full((B, MP), -1, np.int32)
    for b, n in enumerate(pages):
        for i in range(n):
            table[b, i] = next(perm)
    q = torch.tensor(rng.standard_normal((B, H, hd)), dtype=torch.float32)
    kp = torch.tensor(rng.standard_normal((P, T, KV, hd)),
                      dtype=torch.float32)
    vp = torch.tensor(rng.standard_normal((P, T, KV, hd)),
                      dtype=torch.float32)
    kp[-2:], vp[-2:] = 1e4, -1e4
    return (q.to(dtype).to(device), kp.to(dtype).to(device),
            vp.to(dtype).to(device), torch.tensor(table).to(device),
            torch.tensor(lengths, dtype=torch.int32).to(device))


def _direct(q, kp, vp, table, lengths, window):
    """Softmax over each row's keys ``max(0, n - window)..n-1`` gathered
    one by one, in f32."""
    B, H, hd = q.shape
    KV = kp.shape[2]
    out = torch.zeros((B, H, hd))
    for b in range(B):
        n = int(lengths[b])
        lo = max(0, n - window) if window else 0
        pos = torch.arange(lo, n)
        pg = table[b, pos // T].long()
        k = kp[pg, pos % T].float()                    # [n, KV, hd]
        v = vp[pg, pos % T].float()
        qg = q[b].float().reshape(KV, H // KV, hd)
        s = torch.einsum("kgh,tkh->kgt", qg, k) / math.sqrt(hd)
        out[b] = torch.einsum("kgt,tkh->kgh", torch.softmax(s, -1),
                              v).reshape(H, hd)
    return out


@pytest.mark.parametrize("H,KV", [(64, 8), (48, 1)])
@pytest.mark.parametrize("window", [W, 16])
def test_plain_window_attends_the_last_keys(H, KV, window):
    """The plain version with a window equals a softmax over each row's
    last ``window`` keys, at K-EXAONE's heads (64 over 8) and granite's
    (48 over 1)."""
    B, hd = len(LENGTHS), 16
    a = _inputs(B, H, KV, hd, LENGTHS, 40, seed=H + window)
    got = paged_attention_plain(*a, window=window)
    torch.testing.assert_close(got, _direct(*a, window), rtol=TOL, atol=TOL)
    # no window: every key, as before the argument
    torch.testing.assert_close(paged_attention_plain(*a, window=0),
                               _direct(*a, 0), rtol=TOL, atol=TOL)
    assert torch.equal(paged_attention_plain(*a, window=0),
                       paged_attention_plain(*a))


def _mirror(q, kp, vp, table, lengths, window, per):
    """The split kernels' window arithmetic, then the combine: row b's
    splits start at the page holding its first key (``window_base``), its
    live ones are ``ceil((min(n, MP T) - base) / (per T))``, split s takes
    tokens ``[max(base + s per T, lo), min(base + (s + 1) per T, n))``;
    each gives (m, l, acc) per head, merged by log-sum-exp."""
    B, H, hd = q.shape
    KV = kp.shape[2]
    MP = table.shape[1]
    out = torch.zeros((B, H, hd))
    counts = []
    for b in range(B):
        n = int(lengths[b])
        lo = max(0, n - window) if window > 0 else 0
        base = lo // T * T
        live = max(0, min(n, MP * T) - base + per * T - 1) // (per * T) \
            if n > 0 else 0
        counts.append(live)
        parts = []
        for s in range(live):
            start = max(base + s * per * T, lo)
            end = min(base + (s + 1) * per * T, n, MP * T)
            pos = torch.arange(start, end)
            pg = table[b, pos // T].long()
            k, v = kp[pg, pos % T], vp[pg, pos % T]
            qg = q[b].reshape(KV, H // KV, hd)
            sc = torch.einsum("kgh,tkh->kgt", qg, k) / math.sqrt(hd)
            m = sc.amax(-1)
            e = torch.exp(sc - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum("kgt,tkh->kgh", e, v)))
        if not parts:
            continue
        M = torch.stack([p[0] for p in parts]).amax(0)
        wts = [torch.exp(p[0] - M) for p in parts]
        L = sum(p[1] * w for p, w in zip(parts, wts))
        acc = sum(p[2] * w[..., None] for p, w in zip(parts, wts))
        out[b] = (acc / L[..., None]).reshape(H, hd)
    return out, counts


@pytest.mark.parametrize("B,KV,G,MP", [(32, 8, 8, 128), (32, 1, 48, 128),
                                       (16, 2, 6, 40)])
@pytest.mark.parametrize("window", [0, W, 40])
def test_window_split_mirror_matches_plain(B, KV, G, MP, window):
    """The kernels' splits under a window, mirrored on the CPU at the
    plan the wrapper makes (``split_plan`` over ``window_columns``): the
    combined partials give the plain version's output, no row has more
    live splits than the plan, and the splits follow the pages in the
    window, not the page table's width."""
    lengths = (LENGTHS * 3)[:B]
    a = _inputs(B, KV * G, KV, 16, lengths, MP, seed=B + window)
    n_splits, per = split_plan(B, KV, window_columns(MP, T, window), T=T,
                               G=G)
    got, live = _mirror(*a, window, per)
    want = paged_attention_plain(*a, window=window)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert max(live) <= n_splits
    if window:
        assert n_splits <= -(-window_columns(MP, T, window) // per)
        assert window_columns(MP, T, window) == -(-(window + T - 1) // T)


def test_window_columns_and_pages_read():
    assert window_columns(128, 32, 0) == 128
    assert window_columns(128, 32, 128) == 5       # 128 keys over 5 pages
    assert window_columns(128, 32, 1) == 1
    assert window_columns(3, 32, 128) == 3
    # n keys from max(0, n - W) over pages of 32
    for n, want_w, want_f in ((1, 1, 1), (32, 1, 1), (33, 2, 2),
                              (128, 4, 4), (129, 5, 5), (160, 4, 5),
                              (161, 5, 6), (1000, 5, 32)):
        assert pages_read([n], 32, 128) == want_w, n
        assert pages_read([n], 32) == want_f, n
    assert pages_read([0, 160, 161], 32, 128) == 9


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,dtype", [
    (64, 8, 128, torch.bfloat16),      # K-EXAONE: tensor cores, G 8
    (48, 1, 128, torch.bfloat16),      # granite: tensor cores, G 48
    (64, 8, 128, torch.float32),       # CUDA cores
    (16, 2, 136, torch.bfloat16),      # CUDA cores, bf16 past hd 128
])
def test_cuda_window_matches_plain(cuda_device, H, KV, hd, dtype):
    """Both routes against the plain version at the decode batch (B 32,
    MP 128) with lengths below, at and past the window around page edges,
    each windowed call counted once as ``paged_attention.windowed``; at
    window 0 the kernels equal, bit for bit, a window no row reaches (the
    same plan and splits)."""
    lengths = (LENGTHS * 2)[:32]
    a = _inputs(32, H, KV, hd, lengths, 128, seed=H, dtype=dtype,
                device=cuda_device)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
    before = cuda_build.launch_counts().get(WINDOWED_LAUNCHES, 0)
    for window in (W, 40):
        got = paged_attention_cuda(*a, window=window)
        torch.testing.assert_close(
            got.float(), paged_attention_plain(*a, window=window).float(),
            rtol=tol, atol=tol)
    assert cuda_build.launch_counts()[WINDOWED_LAUNCHES] == before + 2
    full = paged_attention_cuda(*a, window=0)
    assert cuda_build.launch_counts()[WINDOWED_LAUNCHES] == before + 2
    torch.testing.assert_close(full.float(),
                               paged_attention_plain(*a).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(full, paged_attention_cuda(*a))
    assert torch.equal(full, paged_attention_cuda(*a, window=128 * T))
