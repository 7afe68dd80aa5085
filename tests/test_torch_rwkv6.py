"""The port's RWKV6 family against ``repro`` on rwkv6-7b reduced (2 layers,
d_model 64, head size 16).

Scan inputs are made with numpy from a seed and handed to both packages;
model params come from the reference's ``Model.init(jax.random.key(0))``
(with the bonus ``u`` and the decay bias ``w0`` redrawn from numpy, so the
model tests exercise both) and reach the port through
``interop.params_from_numpy``.  Tolerances: the scans within 2e-4, the
JAX package's own tolerance for its kernel (``tests/test_kernels.py``);
logits and cache leaves within 1e-4 (f32), as in ``test_torch_model.py``.
The Pallas kernel runs in interpret mode, as the JAX package's tests run it
on the CPU.  Tests marked ``cuda`` hold the CUDA kernel against its plain
version and skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6_scan
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro.models.rwkv6 import wkv_chunked as jwkv_chunked
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import cuda_build, ops, ref
from repro_torch.kernels.rwkv6_scan import (W_MIN, rwkv6_scan_cuda,
                                            rwkv6_scan_plain, scan_plan)
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.models.rwkv6 import wkv_chunked
from repro_torch.models.transformer import RWKV_KEYS
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

SCAN_TOL = 2e-4
TOL = 1e-4
S_MAX = 160
ARCH = "rwkv6-7b"


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    GLOBAL_METRICS.reset()
    yield


# ------------------------------------------------------------------ scans
def _scan_inputs(seed, B, S, H, N, decay="weak", state_scale=0.1):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    if decay == "strong":              # numerical stress: w down to ~0.01
        w = np.exp(-np.exp(rng.uniform(-2.0, 1.5, (B, S, H, N))))
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, N))))
        w = w * 0.3 + 0.69
    u = (rng.standard_normal((H, N)) * 0.2).astype(np.float32)
    st = (rng.standard_normal((B, H, N, N)) * state_scale).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, st


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, expect, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=tol, atol=tol)


def test_rwkv6_ref_matches_reference():
    inputs = _scan_inputs(0, 2, 20, 3, 16, "strong")
    out, st = ref.rwkv6_ref(*_t(inputs))
    jout, jst = jax.jit(jref.rwkv6_ref)(*_j(inputs))
    _close(out, jout, SCAN_TOL)
    _close(st, jst, SCAN_TOL)


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 64, 2, 16, 16),
    (2, 128, 4, 32, 32),
    (1, 96, 1, 64, 32),     # uneven nc
    (2, 64, 3, 16, 64),     # single chunk
])
@pytest.mark.parametrize("decay", ["weak", "strong"])
def test_plain_scan_matches_pallas_kernel(B, S, H, N, chunk, decay):
    """The sweep of the JAX package's own kernel test, same shapes."""
    inputs = _scan_inputs(1, B, S, H, N, decay)
    out, st = rwkv6_scan_plain(*_t(inputs), chunk=chunk)
    jout, jst = jrwkv6_scan(*_j(inputs), chunk=chunk, interpret=True)
    assert out.dtype == st.dtype == torch.float32
    _close(out, jout, SCAN_TOL)
    _close(st, jst, SCAN_TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv_chunked_matches_reference(chunk):
    inputs = _scan_inputs(2, 2, 64, 4, 16, "strong")
    out, st = wkv_chunked(*_t(inputs), chunk=chunk)
    jout, jst = jwkv_chunked(*_j(inputs), chunk=chunk)
    _close(out, jout, SCAN_TOL)
    _close(st, jst, SCAN_TOL)


@pytest.mark.parametrize("S", [70, 100])
def test_ragged_length_matches_the_oracle(S):
    """A ragged last chunk: the reference's chunked path asserts
    ``S % chunk == 0`` and cannot run it; the port pads the chunk with
    neutral tokens and agrees with the per-token oracle."""
    inputs = _scan_inputs(3, 2, S, 3, 16, "weak")
    jout, jst = jax.jit(jref.rwkv6_ref)(*_j(inputs))
    for out, st in (rwkv6_scan_plain(*_t(inputs), chunk=64),
                    wkv_chunked(*_t(inputs), chunk=32),
                    ref.rwkv6_ref(*_t(inputs))):
        assert out.shape == (2, S, 3, 16)
        _close(out, jout, SCAN_TOL)
        _close(st, jst, SCAN_TOL)
    with pytest.raises(AssertionError):
        jwkv_chunked(*_j(inputs), chunk=64)


def test_zero_decay_is_finite_and_matches_reference():
    """``w`` holding exact zeros.  The reference clamps w at 1e-38 before
    its log, a subnormal that XLA on the CPU flushes to 0: log(0) = -inf
    and its chunked scans return NaN.  The port clamps at the smallest
    normal float, stays finite and agrees with the reference's per-token
    oracle, which takes no log."""
    r, k, v, w, u, st = _scan_inputs(4, 1, 64, 2, 16, "strong")
    w[:, ::7] = 0.0
    w[:, :, 1, :4] = 0.0
    inputs = (r, k, v, w, u, st)
    oout, ost = jax.jit(jref.rwkv6_ref)(*_j(inputs))
    for out, st_out in (rwkv6_scan_plain(*_t(inputs), chunk=32),
                        wkv_chunked(*_t(inputs), chunk=64)):
        assert torch.isfinite(out).all() and torch.isfinite(st_out).all()
        _close(out, oout, SCAN_TOL)
        _close(st_out, ost, SCAN_TOL)
    jout, _ = jrwkv6_scan(*_j(inputs), chunk=32, interpret=True)
    assert np.isnan(np.asarray(jout)).any()
    jout, _ = jwkv_chunked(*_j(inputs), chunk=64)
    assert np.isnan(np.asarray(jout)).any()


def test_dispatcher_takes_the_plain_path_on_the_cpu():
    inputs = _t(_scan_inputs(5, 1, 24, 2, 16))
    before = ops.dispatch_counts()["rwkv6_scan"]
    launched = cuda_build.launch_counts().get("rwkv6_scan", 0)
    out, st = ops.rwkv6_scan(*inputs)
    assert ops.dispatch_counts()["rwkv6_scan"] == before + 1
    assert cuda_build.launch_counts().get("rwkv6_scan", 0) == launched
    pout, pst = rwkv6_scan_plain(*inputs)
    torch.testing.assert_close(out, pout, rtol=0, atol=0)
    torch.testing.assert_close(st, pst, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan_cuda(*_t(_scan_inputs(6, 1, 8, 2, 16)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _edge_inputs(seed, B, S, H, N, kind, state_scale=0.1):
    """``_scan_inputs`` of one kind: weak or strong decay, or strong decay
    with exact zeros in w (every 7th token, and 4 channels of head 1)."""
    r, k, v, w, u, st = _scan_inputs(seed, B, S, H, N,
                                     "weak" if kind == "weak" else "strong",
                                     state_scale)
    if kind == "zeros":
        w[:, ::7] = 0.0
        w[:, :, min(1, H - 1), :4] = 0.0
    return r, k, v, w, u, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 16, 17, 64, 65, 100, 256, 257])
@pytest.mark.parametrize("kind", ["weak", "strong", "zeros"])
def test_cuda_kernel_matches_plain(cuda_device, dtype, S, kind):
    """On the card: the kernel against its plain version on the same
    (bf16-rounded) inputs, at S on and across the kernel's sub-chunk (16)
    and chunk (64) edges; only the order of the sums and the split-TF32
    products differ."""
    r, k, v, w, u, st = (t.to(cuda_device) for t in _t(
        _edge_inputs(7, 2, S, 4, 64, kind)))
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    out, st_out = rwkv6_scan_cuda(r, k, v, w, u, st)
    pout, pst = rwkv6_scan_plain(r, k, v, w, u, st)
    assert torch.isfinite(out).all() and torch.isfinite(st_out).all()
    torch.testing.assert_close(out, pout, rtol=SCAN_TOL, atol=SCAN_TOL)
    torch.testing.assert_close(st_out, pst, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("B,H,N,sms,groups", [
    (1, 64, 64, 132, 2),    # the full-width prefill: 128 blocks
    (1, 64, 64, 114, 1),    # a card with fewer SMs
    (1, 4, 64, 132, 4),     # few heads: every group of 16 columns
    (2, 4, 32, 132, 2),     # N = 32: at most two groups of 16
    (2, 4, 16, 132, 1),     # N = 16: one group
    (8, 64, 64, 132, 1),    # a batch that fills the card alone
])
def test_scan_plan_follows_the_card(B, H, N, sms, groups):
    got = scan_plan(B, H, N, sm_count=sms)
    assert got == groups
    assert N // got >= 16 and (N // got) % 16 == 0
    assert got == 1 or B * H * got <= sms


# ------------------------------------------- the kernel's decomposition
def _tf32(x):
    """Round f32 to TF32 to nearest, ties away from zero (``cvt.rna``, as
    the kernel does it): add half a unit of TF32's last place (bit 12) to
    the bit pattern, clear the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an f32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_split(a, b, exact_b=False):
    """a @ b as the kernel's tensor cores take it: each operand split into
    hi, rounded to TF32, and the remainder lo, which the tensor cores
    truncate to TF32; lo.hi + hi.lo + hi.hi (no hi.lo for an exact b)."""
    a_hi = _tf32(a)
    a_lo = _tf32_trunc(a - a_hi)
    b_hi = _tf32(b)
    out = a_lo @ b_hi
    if not exact_b:
        out = out + a_hi @ _tf32_trunc(b - b_hi)
    return out + a_hi @ b_hi


def _mm_one_pass(a, b, exact_b=False):
    """a @ b with each operand rounded to TF32 once."""
    return _tf32(a) @ _tf32(b)


def _kernel_mirror(r, k, v, w, u, state, mm=_mm_split):
    """The CUDA kernel's arithmetic in torch (csrc/rwkv6_scan.cu): chunks of
    64 tokens in sub-chunks of 16, decays as running products of w, the
    8x8 triangles on the score's diagonal (and the bonus on it) in f32, and
    every other product through ``mm`` (the tensor cores).  A ragged last
    chunk is zero-filled with w = 1, as the kernel's copies leave it."""
    B, S, H, N = r.shape
    T, Q, NS = 64, 16, 4
    f32 = torch.float32
    exact_v = v.dtype == torch.bfloat16
    r, k, v = (a.to(f32).permute(0, 2, 1, 3) for a in (r, k, v))
    w = torch.clamp(w.to(f32), min=W_MIN).permute(0, 2, 1, 3)
    u = u.to(f32)[None]
    st = state.to(f32)
    outs = []
    for t0 in range(0, S, T):
        nt = min(T, S - t0)
        rc, kc, vc = (torch.nn.functional.pad(a[:, :, t0:t0 + nt],
                                              (0, 0, 0, T - nt))
                      for a in (r, k, v))
        wc = torch.nn.functional.pad(w[:, :, t0:t0 + nt], (0, 0, 0, T - nt),
                                     value=1.0)
        # 1a. prefix and suffix products per sub-chunk, and their totals
        rp, kq = torch.empty_like(rc), torch.empty_like(kc)
        tot = []
        for i in range(NS):
            p = torch.ones_like(rc[:, :, 0])
            for t in range(i * Q, (i + 1) * Q):
                rp[:, :, t] = rc[:, :, t] * p
                p = p * wc[:, :, t]
            tot.append(p)
            q = torch.ones_like(p)
            for t in reversed(range(i * Q, (i + 1) * Q)):
                kq[:, :, t] = kc[:, :, t] * q
                q = q * wc[:, :, t]
        # 1b. the 8x8 triangles of each sub-chunk's diagonal block on CUDA
        # cores: a running product from s to t within a half sub-chunk
        score = torch.zeros((B, H, T, T), dtype=f32)
        for s in range(T):
            score[:, :, s, s] = (rc[:, :, s] * (u * kc[:, :, s])).sum(-1)
            kd = kc[:, :, s]
            for t in range(s + 1, (s // 8 + 1) * 8):
                score[:, :, t, s] = (rc[:, :, t] * kd).sum(-1)
                kd = kd * wc[:, :, t]
        # 1c. the 8x8 block below each triangle pair, t in the second half
        # of a sub-chunk and s in the first, with the decays restarted at
        # the half: (r * pe8) (k * q8)^T on the tensor cores
        for i in range(NS):
            mid = i * Q + Q // 2
            rp8, kq8 = torch.empty_like(rc[:, :, :8]), torch.empty_like(
                kc[:, :, :8])
            p = torch.ones_like(rc[:, :, 0])
            for t in range(8):
                rp8[:, :, t] = rc[:, :, mid + t] * p
                p = p * wc[:, :, mid + t]
            q = torch.ones_like(p)
            for t in reversed(range(8)):
                kq8[:, :, t] = kc[:, :, mid - 8 + t] * q
                q = q * wc[:, :, mid - 8 + t]
            score[:, :, mid:mid + 8, mid - 8:mid] = mm(
                rp8, kq8.transpose(-1, -2))
        # 2a. off-diagonal blocks: RP_i (KQ_j prod_{j<m<i} Tot_m)^T
        for i in range(1, NS):
            for j in range(i):
                f = torch.ones_like(tot[0])
                for m in range(j + 1, i):
                    f = f * tot[m]
                kb = kq[:, :, j * Q:(j + 1) * Q] * f[:, :, None]
                score[:, :, i * Q:(i + 1) * Q, j * Q:(j + 1) * Q] = mm(
                    rp[:, :, i * Q:(i + 1) * Q], kb.transpose(-1, -2))
        # 2b. the carry: diag(prod Tot) S + (KQ prod_{m>j} Tot_m)^T v
        e = [torch.ones_like(tot[0])]
        for j in range(NS - 2, -1, -1):
            e.insert(0, e[0] * tot[j + 1])
        kcarry = torch.cat([kq[:, :, j * Q:(j + 1) * Q] * e[j][:, :, None]
                            for j in range(NS)], dim=2)
        carry = st * (e[0] * tot[0])[..., None] + mm(
            kcarry.transpose(-1, -2), vc, exact_v)
        # 3. out = (RP_i prod_{m<i} Tot_m) S + scores v
        out = []
        for i in range(NS):
            f = torch.ones_like(tot[0])
            for m in range(i):
                f = f * tot[m]
            rows = slice(i * Q, (i + 1) * Q)
            out.append(mm(rp[:, :, rows] * f[:, :, None], st)
                       + mm(score[:, :, rows, :(i + 1) * Q],
                            vc[:, :, :(i + 1) * Q], exact_v))
        outs.append(torch.cat(out, dim=2)[:, :, :nt])
        st = carry
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3), st


#: chip_smoke's scan inputs at a narrow width (H = 2):
#: (B, S, N, kind, state scale)
DECOMPOSITION_CASES = {
    "full width": (1, 256, 64, "weak", 0.0),
    "single chunk": (1, 17, 64, "weak", 0.0),
    "ragged S": (1, 100, 64, "weak", 0.0),
    "strong decay": (1, 256, 64, "strong", 0.0),
    "w with zeros": (1, 130, 64, "zeros", 0.0),
    "B=2, state": (2, 96, 64, "weak", 0.5),
    "head size 16": (2, 70, 16, "strong", 0.5),
}


def _decomposition_inputs(case, dtype):
    B, S, N, kind, scale = DECOMPOSITION_CASES[case]
    r, k, v, w, u, st = _t(_edge_inputs(12, B, S, 2, N, kind, scale))
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u, st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECOMPOSITION_CASES))
def test_kernel_decomposition_matches_plain(case, dtype):
    """The arithmetic the CUDA kernel runs (sub-chunk factoring, running
    products, split-TF32 products emulated bit for bit) against the plain
    version, within the kernel's own 2e-4, on chip_smoke's scan inputs."""
    inputs = _decomposition_inputs(case, dtype)
    out, st = _kernel_mirror(*inputs)
    pout, pst = rwkv6_scan_plain(*inputs)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    torch.testing.assert_close(out, pout, rtol=SCAN_TOL, atol=SCAN_TOL)
    torch.testing.assert_close(st, pst, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_kernel_decomposition_matches_pallas_kernel():
    """The same mirror against the Pallas kernel in interpret mode."""
    inputs = _decomposition_inputs("strong decay", torch.float32)
    out, st = _kernel_mirror(*inputs)
    jout, jst = jrwkv6_scan(*_j([a.numpy() for a in inputs]),
                            interpret=True)
    _close(out, jout, SCAN_TOL)
    _close(st, jst, SCAN_TOL)


def test_one_tf32_pass_would_miss_the_tolerance():
    """Why the kernel splits its operands: the same decomposition with each
    operand rounded to TF32 once is far outside 2e-4."""
    inputs = _decomposition_inputs("full width", torch.bfloat16)
    out, _ = _kernel_mirror(*inputs, mm=_mm_one_pass)
    pout, _ = rwkv6_scan_plain(*inputs)
    assert float((out - pout).abs().max()) > 10 * SCAN_TOL


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def jax_params():
    """The reference's init, with ``bonus_u`` (zero there) and
    ``decay_w0`` redrawn so that the bonus term and a stronger,
    channel-dependent decay take part."""
    cfg = jget_config(ARCH).reduced()
    params = jbuild_model(cfg, JFlags(remat=False)).init(jax.random.key(0))
    rwkv = params["trunk"]["rwkv"]
    rng = np.random.default_rng(11)
    rwkv["bonus_u"] = jnp.asarray(
        rng.standard_normal(rwkv["bonus_u"].shape).astype(np.float32) * 0.5)
    rwkv["decay_w0"] = jnp.asarray(
        rng.uniform(-3.0, 1.0, rwkv["decay_w0"].shape).astype(np.float32))
    return params


def _torch_params(jax_params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")


def _pair(jax_params, **flags):
    jmodel = jbuild_model(jget_config(ARCH).reduced(),
                          JFlags(remat=False, **flags))
    tmodel = build_model(get_config(ARCH).reduced(),
                         Flags(remat=False, **flags), device="cpu")
    return jmodel, tmodel, _torch_params(jax_params)


def test_params_carry_over_key_for_key(jax_params):
    _, tmodel, tparams = _pair(jax_params)
    jflat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert any("bonus_u" in str(path) for path, _ in jflat)
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own seeded init builds the same tree, key for key
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(tparams))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("flags", [
    {}, {"use_kernels": True}, {"fuse_rwkv_proj": True},
    {"scan_chunk": 16}])
@pytest.mark.parametrize("S", [13, 128])
def test_prefill_matches_reference(jax_params, flags, S):
    jmodel, tmodel, tparams = _pair(jax_params, **flags)
    tokens = np.random.default_rng(S).integers(0, 128, (2, S)).astype(
        np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens)},
        jmodel.init_cache(2, S_MAX))
    before = ops.dispatch_counts()["rwkv6_scan"]
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.from_numpy(tokens)},
        tmodel.init_cache(2, S_MAX))
    used = ops.dispatch_counts()["rwkv6_scan"] - before
    assert used == (tmodel.cfg.num_layers if flags.get("use_kernels")
                    else 0)
    _close(tlogits, jlogits, TOL)
    assert set(tcache) == set(jcache) == {"step", *RWKV_KEYS}
    for key in RWKV_KEYS:
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], TOL)
    assert tcache["step"] == int(jcache["step"]) == S


def test_decode_step_matches_reference(jax_params):
    jmodel, tmodel, tparams = _pair(jax_params)
    tokens = np.random.default_rng(2).integers(0, 128, (2, 9)).astype(
        np.int32)
    _, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens)},
        jmodel.init_cache(2, S_MAX))
    _, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                               tmodel.init_cache(2, S_MAX))
    nxt = np.asarray([[5], [77]], np.int32)
    for _ in range(3):
        jlogits, jcache = jax.jit(jmodel.decode_step)(
            jax_params, jcache, jnp.asarray(nxt))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(nxt))
        _close(tlogits, jlogits, TOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for key in RWKV_KEYS:
        _close(tcache[key], jcache[key], TOL)
    assert tcache["step"] == int(jcache["step"]) == 12


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ragged_prefill_equals_token_by_token_decode(jax_params,
                                                     use_kernels):
    """A 100-token prompt (ragged against the chunk of 64, which the
    reference cannot prefill) gives the same logits and state as feeding
    its tokens one decode step at a time from an empty cache."""
    _, tmodel, tparams = _pair(jax_params, use_kernels=use_kernels)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (1, 100)).astype(np.int32))
    plogits, pcache = tmodel.prefill(tparams, {"tokens": tokens},
                                     tmodel.init_cache(1, S_MAX))
    cache = tmodel.init_cache(1, S_MAX)
    for t in range(100):
        dlogits, cache = tmodel.decode_step(tparams, cache,
                                            tokens[:, t:t + 1])
    torch.testing.assert_close(plogits, dlogits, rtol=TOL, atol=TOL)
    for key in RWKV_KEYS:
        torch.testing.assert_close(pcache[key], cache[key], rtol=TOL,
                                   atol=TOL)


# ------------------------------------------------------------------ serve
def _engines(jax_params, use_kernels=False, jax_ecfg=None, **ecfg):
    cfg_kw = dict(decode_slots=2, max_seq_len=S_MAX, page_tokens=8,
                  onboard_pages=4, round_time_s=1e-3)
    cfg_kw.update(ecfg)
    jeng = JServeEngine(
        jbuild_model(jget_config(ARCH).reduced(),
                     JFlags(remat=False, use_kernels=use_kernels)),
        jax_params, jsystem_for("dev0", host_id="h0", pool_gib=1,
                                page_bytes=4096),
        JEngineConfig(**{**cfg_kw, **(jax_ecfg or {})}), device_id="dev0")
    teng = ServeEngine(
        build_model(get_config(ARCH).reduced(),
                    Flags(remat=False, use_kernels=use_kernels),
                    device="cpu"),
        _torch_params(jax_params),
        system_for("dev0", host_id="h0", pool_gib=1, page_bytes=4096),
        EngineConfig(**cfg_kw), device_id="dev0", device="cpu")
    return jeng, teng


def _serve(eng, spec, prompts, max_new):
    rids = [eng.submit(spec(prompt=p, max_new_tokens=max_new))
            for p in prompts]
    eng.run(400)
    assert all(eng.requests[r].state == "done" for r in rids)
    return [eng.requests[r].out_tokens for r in rids]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_serving_matches_reference(jax_params, use_kernels):
    """``kv_prefetch=False`` on both sides, the one setting the reference
    serves RWKV6 with: identical token streams, no LMB traffic (the state
    stays in the dense slot by design) and one scan per prompt and
    layer."""
    prompts = _prompts(7, (5, 13, 20, 9, 17))
    jeng, teng = _engines(jax_params, use_kernels, kv_prefetch=False)
    jstreams = _serve(jeng, JSubmitSpec, prompts, 6)
    before = ops.dispatch_counts()["rwkv6_scan"]
    tstreams = _serve(teng, SubmitSpec, prompts, 6)
    scans = ops.dispatch_counts()["rwkv6_scan"] - before
    assert tstreams == jstreams
    assert teng.kv.buf.host.fm.op_bytes() == jeng.kv.buf.host.fm.op_bytes() \
        == {}
    assert teng.stats()["decode_path"] == jeng.stats()["decode_path"] \
        == "dense"
    assert teng.paged_rounds == 0
    assert scans == (len(prompts) * teng.cfg.num_layers if use_kernels
                     else 0)


def test_default_engine_config_serves_where_the_reference_raises(
        jax_params):
    """With the default ``kv_prefetch=True`` the reference asks the KV
    store for the tail page of a sequence that holds none and raises
    ``IndexError``; the port prefetches nothing for it and serves the same
    streams as the reference does with prefetch off."""
    prompts = _prompts(8, (5, 13, 20, 9))
    jeng, _ = _engines(jax_params)
    with pytest.raises(IndexError):
        _serve(jeng, JSubmitSpec, prompts, 5)
    jeng, teng = _engines(jax_params, jax_ecfg={"kv_prefetch": False})
    assert teng.ecfg.kv_prefetch and not jeng.ecfg.kv_prefetch
    assert _serve(teng, SubmitSpec, prompts, 5) == \
        _serve(jeng, JSubmitSpec, prompts, 5)
    assert teng.kv.buf.host.fm.op_bytes() == {}


def test_port_serves_a_ragged_prompt_longer_than_a_chunk(jax_params):
    """Prompt lengths of the full-width serve run (96, 130) on the reduced
    model: the reference's prefill asserts on them; the port serves them
    and its first token is the argmax of its own prefill logits."""
    prompts = _prompts(9, (96, 130))
    _, teng = _engines(jax_params, use_kernels=True)
    streams = _serve(teng, SubmitSpec, prompts, 4)
    model = teng.model
    for p, s in zip(prompts, streams):
        logits, _ = model.prefill(teng.params,
                                  {"tokens": torch.from_numpy(p[None])},
                                  model.init_cache(1, S_MAX))
        assert int(torch.argmax(logits[0])) == s[0]


def test_launcher_serves_rwkv6_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert '"done": 3' in out and '"decode_path": "dense"' in out
