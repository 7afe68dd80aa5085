"""The port's MoE family against ``repro`` on dbrx-132b and mixtral-8x22b
reduced (2 layers, d_model 64, 4 experts, top-2; mixtral with a window of
16).

Params come from the reference's ``Model.init(jax.random.key(0))`` and
reach the port through ``interop.params_from_numpy``; activations, tokens,
pools and tables are made with numpy from a seed.  Tolerances (f32): the
MoE layer within 1e-5, logits within 1e-4, as in ``test_torch_model.py``:
the two packages sum the same products in different orders.  Serving runs
the reference in its modelling mode (``backend_memory_kinds`` patched to
``("device",)``, as in ``test_torch_serve.py``).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models.flags import Flags as JFlags
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec

MOE_TOL = 1e-5
TOL = 1e-4
S_MAX = 64
ARCHS = ("dbrx-132b", "mixtral-8x22b")


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture(scope="module")
def jax_params():
    """The reference's init of each reduced config, made once."""
    return {arch: jbuild_model(jget_config(arch).reduced(),
                               JFlags(remat=False)).init(jax.random.key(0))
            for arch in ARCHS}


def _torch_params(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _close(got, expect, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=tol, atol=tol)


# -------------------------------------------------------------- the layer
def _expert_outputs(p, cfg, x):
    """Every expert's FFN on every token: [T, E, D] (f32, no routing)."""
    xt = x.reshape(-1, x.shape[-1])
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["w_gate"])
                                 ) * torch.einsum("td,edf->tef", xt,
                                                  p["w_up"])
    return torch.einsum("tef,efd->ted", h, p["w_down"])


def _explained_keep(y_ref, p, cfg, x, weights, ids):
    """For each token, the subset of its K choices whose gated expert
    outputs sum to the reference's output: the reference's kept set, read
    from its result alone.  Returns (keep [T, K] bool, the best fit's
    error, the second best's)."""
    outs = _expert_outputs(p, cfg, x)                       # [T, E, D]
    T, K = ids.shape
    y = torch.from_numpy(np.array(y_ref)).reshape(T, -1)
    keep = torch.zeros((T, K), dtype=torch.bool)
    best, second = [], []
    for t in range(T):
        fits = []
        for subset in itertools.product((False, True), repeat=K):
            m = torch.tensor(subset)
            pred = torch.sum((weights[t] * m)[:, None] * outs[t, ids[t]],
                             dim=0)
            fits.append((float((pred - y[t]).abs().max()), subset))
        fits.sort()
        keep[t] = torch.tensor(fits[0][1])
        best.append(fits[0][0])
        second.append(fits[1][0])
    return keep, max(best), min(second)


@pytest.mark.parametrize("arch,B,S,group,cf", [
    ("dbrx-132b", 2, 16, 8, None),       # the group divides T
    ("dbrx-132b", 2, 13, 8, None),       # 26 tokens: the group halves to 2
    ("mixtral-8x22b", 2, 12, 16, None),  # 24 tokens: the group halves to 8
    ("mixtral-8x22b", 3, 7, 8, None),    # 21 tokens: groups of 1
    ("mixtral-8x22b", 1, 9, 1024, None),  # default group, capped at T
    ("dbrx-132b", 2, 16, 16, 0.5),       # capacity lowered: pairs dropped
    ("mixtral-8x22b", 2, 12, 24, 0.5),
])
def test_moe_apply_matches_reference(jax_params, arch, B, S, group, cf):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jax_params[arch]["trunk"]["moe"])
    tp = _torch_params(jp)
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(x), JFlags(moe_group=group))
    xt = torch.from_numpy(x)
    ty, taux = moe.moe_apply(tp, cfg, xt, Flags(moe_group=group))
    _close(ty, jy, MOE_TOL)
    _close(taux, jaux, MOE_TOL)

    g = moe.group_size(B * S, Flags(moe_group=group))
    _, weights, ids, slot, keep, C = moe.route(
        tp, cfg, xt.reshape(B * S // g, g, -1))
    assert C == int(-(-cfg.top_k * g * cfg.capacity_factor
                      // cfg.num_experts))
    # the kept pairs fill each expert's slots 0..n-1 in claim order
    flat_ids, flat_keep = ids.reshape(-1, g * cfg.top_k), \
        keep.reshape(-1, g * cfg.top_k)
    for grp in range(flat_ids.shape[0]):
        for e in range(cfg.num_experts):
            claims = flat_ids[grp] == e
            n = int(claims.sum())
            assert flat_keep[grp][claims].tolist() == \
                [i < C for i in range(n)]
    ref_keep, err, other = _explained_keep(
        jy, tp, cfg, xt, weights.reshape(B * S, -1),
        ids.reshape(B * S, -1))
    assert err < MOE_TOL and other > 100 * MOE_TOL
    assert torch.equal(ref_keep, keep.reshape(B * S, -1))
    if cf is not None:       # tokens all of whose choices were dropped
        gone = ~keep.reshape(B * S, -1).any(dim=1)
        assert bool(gone.any())
        assert float(ty.reshape(B * S, -1)[gone].abs().max()) == 0.0
        assert float(np.abs(np.asarray(jy).reshape(B * S, -1)[
            gone.numpy()]).max()) == 0.0


def test_top_k_follows_lax_top_k():
    """Descending order, and the weights a softmax over the k taken."""
    logits = np.random.default_rng(0).standard_normal((5, 7, 16)).astype(
        np.float32)
    jw, jids = jmoe._top_k_gating(jnp.asarray(logits), 4)
    tw, tids = moe._top_k_gating(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw, MOE_TOL)
    assert tw.dtype == torch.float32


# ------------------------------------------------------------------ model
def _pair(jax_params, arch, **flags):
    jmodel = jbuild_model(jget_config(arch).reduced(),
                          JFlags(remat=False, **flags))
    tmodel = build_model(get_config(arch).reduced(),
                         Flags(remat=False, **flags), device="cpu")
    return jmodel, tmodel, _torch_params(jax_params[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_key_for_key(jax_params, arch):
    """The f32 router and the [L, E, D, F] experts cross unchanged, and
    the port's own init builds the same tree."""
    _, tmodel, tparams = _pair(jax_params, arch)
    cfg = tmodel.cfg
    jflat = jax.tree_util.tree_flatten_with_path(jax_params[arch])[0]
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    m = tparams["trunk"]["moe"]
    L, E, D, Fd = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    assert tuple(m["w_gate"].shape) == (L, E, D, Fd)
    assert tuple(m["w_down"].shape) == (L, E, Fd, D)
    assert tuple(m["router"].shape) == (L, D, E)
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(tparams))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert own["trunk"]["moe"]["router"].dtype == torch.float32
    # a bf16 model keeps its router in f32, on both sides of the bridge
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               dtype="bfloat16")
    jbf = jbuild_model(jcfg, JFlags(remat=False)).init(jax.random.key(1))
    bf = _torch_params(jbf)["trunk"]["moe"]
    assert bf["router"].dtype == torch.float32
    assert bf["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["w_up"].float().numpy(),
        np.asarray(jbf["trunk"]["moe"]["w_up"]).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_match_reference(jax_params, arch, use_kernels):
    """A 21-token prompt (past mixtral's window of 16), then three decode
    steps: logits and caches within 1e-4."""
    jmodel, tmodel, tparams = _pair(jax_params, arch,
                                    use_kernels=use_kernels)
    tokens = np.random.default_rng(1).integers(0, 128, (2, 21)).astype(
        np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params[arch], {"tokens": jnp.asarray(tokens)},
        jmodel.init_cache(2, S_MAX))
    before = ops.dispatch_counts()["flash_attention"]
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.from_numpy(tokens)},
        tmodel.init_cache(2, S_MAX))
    assert ops.dispatch_counts()["flash_attention"] - before == \
        (tmodel.cfg.num_layers if use_kernels else 0)
    _close(tlogits, jlogits, TOL)
    nxt = np.asarray([[5], [77]], np.int32)
    for _ in range(3):
        jlogits, jcache = jax.jit(jmodel.decode_step)(
            jax_params[arch], jcache, jnp.asarray(nxt))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(nxt))
        _close(tlogits, jlogits, TOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_decode_step_paged_matches_reference(jax_params):
    arch = "dbrx-132b"
    jmodel, tmodel, tparams = _pair(jax_params, arch)
    assert tmodel.supports_paged_decode() and jmodel.supports_paged_decode()
    cfg = tmodel.cfg
    P, T = 10, 8
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((P, L, 2, T, KV, hd)).astype(np.float32)
    table = np.asarray([[4, 1, 7, -1], [0, 3, -1, -1], [2, 9, -1, -1]],
                       np.int32)
    lengths = np.asarray([19, 8, 15], np.int32)
    token = rng.integers(0, 128, (3, 1)).astype(np.int32)
    jlogits, jpool = jax.jit(jmodel.decode_step_paged)(
        jax_params[arch], jnp.asarray(pool), jnp.asarray(table),
        jnp.asarray(lengths), jnp.asarray(token))
    tpool = torch.from_numpy(pool.copy())
    before = ops.dispatch_counts()["paged_attention_decode"]
    tlogits, _ = tmodel.decode_step_paged(
        tparams, tpool, torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(token))
    assert ops.dispatch_counts()["paged_attention_decode"] - before == L
    _close(tlogits, jlogits, TOL)
    _close(tpool, jpool, TOL)


def test_mixtral_keeps_the_dense_slot_path(jax_params):
    _, tmodel, _ = _pair(jax_params, "mixtral-8x22b")
    assert not tmodel.supports_paged_decode()


# ------------------------------------------------------------------ serve
@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


def _serve_pair(jax_params, arch, prompts, max_new, **ecfg):
    cfg_kw = dict(decode_slots=2, max_seq_len=S_MAX, page_tokens=8,
                  onboard_pages=8, trace=True, round_time_s=1e-3)
    cfg_kw.update(ecfg)
    jmodel, tmodel, tparams = _pair(jax_params, arch, use_kernels=True)
    jeng = JServeEngine(jmodel, jax_params[arch],
                        jsystem_for("dev0", host_id="h0", pool_gib=1,
                                    page_bytes=4096),
                        JEngineConfig(**cfg_kw), device_id="dev0")
    teng = ServeEngine(tmodel, tparams,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**cfg_kw), device_id="dev0",
                       device="cpu")
    before = ops.dispatch_counts()
    streams = []
    for eng, spec in ((jeng, JSubmitSpec), (teng, SubmitSpec)):
        rids = [eng.submit(spec(prompt=p, max_new_tokens=max_new))
                for p in prompts]
        eng.run(400)
        assert all(eng.requests[r].state == "done" for r in rids)
        streams.append([eng.requests[r].out_tokens for r in rids])
    after = ops.dispatch_counts()
    used = {k: after[k] - before[k] for k in after}
    assert streams[1] == streams[0]                  # identical tokens
    jfm, tfm = jeng.kv.buf.host.fm, teng.kv.buf.host.fm
    assert tfm.op_bytes() == jfm.op_bytes()
    jc = jeng.kv.buf.metrics.tier(jeng.kv.buf.name, "onboard")
    tc = teng.kv.buf.metrics.tier(teng.kv.buf.name, "onboard")
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    assert teng.paged_rounds == jeng.paged_rounds
    assert teng.stats()["decode_path"] == jeng.stats()["decode_path"]

    def xfer_bytes(eng):
        return sum(s.nbytes for s in eng.trace.spans()
                   if s.name == "link.xfer")
    assert xfer_bytes(teng) == xfer_bytes(jeng)
    assert used["flash_attention"] == len(prompts) * tmodel.cfg.num_layers
    return teng, used


@pytest.mark.parametrize("onboard", [8, 4])
def test_dbrx_serving_matches_reference(modelling_reference, jax_params,
                                        onboard):
    """Paged decode; with 4 onboard pages the working set spills."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 100, n).astype(np.int32)
               for n in (5, 13, 20, 9, 17, 20)]
    teng, used = _serve_pair(jax_params, "dbrx-132b", prompts, 6,
                             decode_slots=4 if onboard == 4 else 2,
                             onboard_pages=onboard)
    assert teng.stats()["decode_path"] == "paged"
    assert teng.paged_rounds > 0
    assert used["paged_attention_decode"] == \
        teng.paged_rounds * teng.cfg.num_layers
    tc = teng.kv.buf.metrics.tier(teng.kv.buf.name, "onboard")
    if onboard == 4:
        assert tc.misses > 0
        assert teng.kv.buf.host.fm.op_bytes().get("demand", 0) > 0


def test_mixtral_serving_matches_reference(modelling_reference, jax_params):
    """Dense slot path; prompts longer than the window of 16 hand the KV
    store the ring's 16 entries, as the reference's engine does."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 100, n).astype(np.int32)
               for n in (5, 20, 30, 9)]
    teng, used = _serve_pair(jax_params, "mixtral-8x22b", prompts, 6,
                             onboard_pages=4)
    assert teng.stats()["decode_path"] == "dense"
    assert teng.paged_rounds == 0 and used["paged_attention_decode"] == 0
    assert teng.kv.buf.host.fm.op_bytes().get("demand", 0) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    path = "paged" if arch == "dbrx-132b" else "dense"
    assert '"done": 3' in out and f'"decode_path": "{path}"' in out
