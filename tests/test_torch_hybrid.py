"""The port's hybrid family (attention and SSM heads in parallel) against
``repro`` on hymba-1.5b reduced (2 layers, d_model 64, 4 heads over 1 KV
head, window 16, 2 SSM heads of 64 channels, state 8).

SSD inputs are made with numpy from a seed and handed to both packages;
model params come from the reference's ``Model.init(jax.random.key(0))``
(with ``A_log`` and ``D_skip`` redrawn from numpy, so that every head
decays at its own rate and the skip term takes part) and reach the port
through ``interop.params_from_numpy``.  Tolerances (f32): the scans within
1e-5, logits and cache leaves within 1e-4, as in ``test_torch_model.py``.
The reference's chunked scan asserts that a prompt longer than a chunk is
a whole number of chunks; the port pads, so the ragged cases are held to
the reference's per-token oracle ``ssd_ref``, which takes any length.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.models.flags import Flags as JFlags
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, ssm
from repro_torch.models.flags import Flags
from repro_torch.models.transformer import SSM_KEYS
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

SSD_TOL = 1e-5
TOL = 1e-4
S_MAX = 64
ARCH = "hymba-1.5b"


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    GLOBAL_METRICS.reset()
    yield


def _close(got, expect, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------ scans
def _ssd_inputs(seed, B, S, H=3, P=8, N=4, state_scale=0.5):
    """xh, dt (softplus-sized, > 0), A (< 0), Bm, Cm, state: f32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f),
            -np.exp(rng.uniform(-2.0, 0.5, H)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            (rng.standard_normal((B, H, P, N)) * state_scale).astype(f))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_ssd_ref_matches_reference():
    args = _ssd_inputs(0, 2, 37)
    y, st = ref.ssd_ref(*_t(args))
    jy, jst = jref.ssd_ref(*_j(args))
    _close(y, jy, SSD_TOL)
    _close(st, jst, SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(64, 64), (128, 64), (48, 16),
                                     (13, 64)])
def test_ssd_chunked_matches_reference(S, chunk):
    args = _ssd_inputs(S, 2, S)
    y, st = ssm.ssd_chunked(*_t(args), chunk=chunk)
    jy, jst = jssm.ssd_chunked(*_j(args), chunk=chunk)
    _close(y, jy, SSD_TOL)
    _close(st, jst, SSD_TOL)


@pytest.mark.parametrize("S", [70, 130])
def test_ragged_length_matches_the_oracle(S):
    """The prefill dispatcher (chunk 64) on a ragged S against the
    reference's ``ssd_ref``; the reference's own chunked form asserts."""
    args = _ssd_inputs(S, 2, S)
    before = ops.dispatch_counts()["ssd_scan"]
    y, st = ops.ssd_scan(*_t(args))
    assert ops.dispatch_counts()["ssd_scan"] - before == 1
    jy, jst = jref.ssd_ref(*_j(args))
    assert y.shape == (2, S, 3, 8)
    _close(y, jy, SSD_TOL)
    _close(st, jst, SSD_TOL)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*_j(args))


def test_ssd_step_matches_reference_and_the_chunked_form():
    """One step against the reference's; the chunked form's final state
    equals S steps from the same initial state."""
    args = _ssd_inputs(5, 2, 21)
    xh, dt, A, Bm, Cm, st0 = _t(args)
    y1, st1 = ssm.ssd_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], st0)
    jy1, jst1 = jssm.ssd_step(*_j((args[0][:, 0], args[1][:, 0], args[2],
                                   args[3][:, 0], args[4][:, 0], args[5])))
    _close(y1, jy1, SSD_TOL)
    _close(st1, jst1, SSD_TOL)
    st = st0
    ys = []
    for t in range(xh.shape[1]):
        y, st = ssm.ssd_step(xh[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], st)
        ys.append(y)
    cy, cst = ssm.ssd_chunked(xh, dt, A, Bm, Cm, st0, chunk=8)
    _close(cy, torch.stack(ys, dim=1), SSD_TOL)
    _close(cst, st, SSD_TOL)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def jax_params():
    """The reference's init, with ``A_log`` (zero there) and ``D_skip``
    (one there) redrawn from numpy."""
    cfg = jget_config(ARCH).reduced()
    params = jbuild_model(cfg, JFlags(remat=False)).init(jax.random.key(0))
    p = params["trunk"]["ssm"]
    rng = np.random.default_rng(11)
    p["A_log"] = jnp.asarray(
        rng.uniform(-1.5, 1.0, p["A_log"].shape).astype(np.float32))
    p["D_skip"] = jnp.asarray(
        rng.uniform(0.5, 1.5, p["D_skip"].shape).astype(np.float32))
    return params


def _torch_params(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
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
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(tparams))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # a bf16 model keeps A_log and D_skip in f32 across the bridge
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype="bfloat16")
    bf = _torch_params(jbuild_model(jcfg, JFlags(remat=False)).init(
        jax.random.key(1)))["trunk"]["ssm"]
    assert bf["A_log"].dtype == bf["D_skip"].dtype == torch.float32
    assert bf["in_proj"]["w"].dtype == bf["conv_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S", [13, 64])
def test_prefill_matches_reference(jax_params, use_kernels, S):
    jmodel, tmodel, tparams = _pair(jax_params, use_kernels=use_kernels,
                                    scan_chunk=16)
    tokens = np.random.default_rng(S).integers(0, 128, (2, S)).astype(
        np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens)},
        jmodel.init_cache(2, S_MAX))
    before = ops.dispatch_counts()
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.from_numpy(tokens)},
        tmodel.init_cache(2, S_MAX))
    after = ops.dispatch_counts()
    L = tmodel.cfg.num_layers
    for name in ("ssd_scan", "flash_attention"):
        assert after[name] - before[name] == (L if use_kernels else 0)
    _close(tlogits, jlogits, TOL)
    assert set(tcache) == set(jcache) == {"step", "pos", "k", "v",
                                          *SSM_KEYS}
    for key in ("k", "v", *SSM_KEYS):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key], TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["step"] == int(jcache["step"]) == S


def test_decode_step_matches_reference(jax_params):
    jmodel, tmodel, tparams = _pair(jax_params)
    tokens = np.random.default_rng(2).integers(0, 128, (2, 14)).astype(
        np.int32)
    _, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens)},
        jmodel.init_cache(2, S_MAX))
    _, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                               tmodel.init_cache(2, S_MAX))
    nxt = np.asarray([[5], [77]], np.int32)
    for _ in range(4):       # 14 + 4 tokens: the window of 16 wraps
        jlogits, jcache = jax.jit(jmodel.decode_step)(
            jax_params, jcache, jnp.asarray(nxt))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(nxt))
        _close(tlogits, jlogits, TOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for key in ("k", "v", *SSM_KEYS):
        _close(tcache[key], jcache[key], TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("S", [70, 130])
def test_ragged_prefill_equals_token_by_token_decode(jax_params, S):
    """A prompt ragged against the chunk of 64 (which the reference cannot
    prefill) gives the logits, ring KV and SSM state of feeding its tokens
    one decode step at a time from an empty cache."""
    _, tmodel, tparams = _pair(jax_params, use_kernels=True)
    tokens = torch.from_numpy(np.random.default_rng(S).integers(
        0, 128, (1, S)).astype(np.int32))
    plogits, pcache = tmodel.prefill(tparams, {"tokens": tokens},
                                     tmodel.init_cache(1, S_MAX))
    cache = tmodel.init_cache(1, S_MAX)
    for t in range(S):
        dlogits, cache = tmodel.decode_step(tparams, cache,
                                            tokens[:, t:t + 1])
    torch.testing.assert_close(plogits, dlogits, rtol=TOL, atol=TOL)
    for key in ("k", "v", *SSM_KEYS):
        torch.testing.assert_close(pcache[key], cache[key], rtol=TOL,
                                   atol=TOL)
    assert torch.equal(pcache["pos"], cache["pos"])


# ------------------------------------------------------------------ serve
@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


@pytest.mark.parametrize("onboard", [8, 4])
def test_serving_matches_reference(modelling_reference, jax_params,
                                   onboard):
    """Dense slot path, the SSM state in each request's slot and the KV
    in LMB pages; with 4 onboard pages the pages spill.  Prompts stay
    within the reference's one chunk of 64."""
    cfg_kw = dict(decode_slots=4 if onboard == 4 else 2, max_seq_len=S_MAX,
                  page_tokens=8, onboard_pages=onboard, trace=True,
                  round_time_s=1e-3)
    jmodel, tmodel, tparams = _pair(jax_params, use_kernels=True)
    jeng = JServeEngine(jmodel, jax_params,
                        jsystem_for("dev0", host_id="h0", pool_gib=1,
                                    page_bytes=4096),
                        JEngineConfig(**cfg_kw), device_id="dev0")
    teng = ServeEngine(tmodel, tparams,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**cfg_kw), device_id="dev0",
                       device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 100, n).astype(np.int32)
               for n in (5, 13, 20, 9, 40, 17)]
    streams = []
    before = ops.dispatch_counts()["ssd_scan"]
    for eng, spec in ((jeng, JSubmitSpec), (teng, SubmitSpec)):
        rids = [eng.submit(spec(prompt=p, max_new_tokens=6))
                for p in prompts]
        eng.run(400)
        assert all(eng.requests[r].state == "done" for r in rids)
        streams.append([eng.requests[r].out_tokens for r in rids])
    assert ops.dispatch_counts()["ssd_scan"] - before == \
        len(prompts) * tmodel.cfg.num_layers
    assert streams[1] == streams[0]
    jfm, tfm = jeng.kv.buf.host.fm, teng.kv.buf.host.fm
    assert tfm.op_bytes() == jfm.op_bytes()
    jc = jeng.kv.buf.metrics.tier(jeng.kv.buf.name, "onboard")
    tc = teng.kv.buf.metrics.tier(teng.kv.buf.name, "onboard")
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    assert teng.stats()["decode_path"] == jeng.stats()["decode_path"] \
        == "dense"
    assert tc.hits + tc.misses > 0                # the KV does go to pages
    if onboard == 4:
        assert tc.misses > 0 and tfm.op_bytes().get("demand", 0) > 0


def test_launcher_serves_hymba_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert '"done": 3' in out and '"decode_path": "dense"' in out
