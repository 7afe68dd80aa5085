"""The port's dense model against ``repro.models`` on qwen2-1.5b reduced.

JAX params come from ``Model.init(jax.random.key(0))`` and reach the port
through ``interop.params_from_numpy``; tokens, pools and tables are made
with numpy from a seed and fed to both.  Tolerance 1e-4 (f32): the two
packages sum the same matmuls in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.flags import Flags

TOL = 1e-4
S_MAX = 32


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config("qwen2-1.5b").reduced()
    model = jbuild_model(cfg, JFlags(remat=False))
    return model.init(jax.random.key(0))


def _pair(jax_params, use_kernels=False):
    jmodel = jbuild_model(jget_config("qwen2-1.5b").reduced(),
                          JFlags(remat=False, use_kernels=use_kernels))
    tmodel = build_model(get_config("qwen2-1.5b").reduced(),
                         Flags(remat=False, use_kernels=use_kernels),
                         device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jax_params))
    return jmodel, tmodel, tparams


def _close(got, expect):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=TOL, atol=TOL)


def test_params_carry_over_key_for_key(jax_params):
    _, tmodel, tparams = _pair(jax_params)
    jflat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert len(jflat) == len(jax.tree_util.tree_leaves(jax_params))
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


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_matches_reference(jax_params, use_kernels):
    jmodel, tmodel, tparams = _pair(jax_params, use_kernels)
    tokens = np.random.default_rng(1).integers(0, 128, (2, 13)).astype(
        np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens)},
        jmodel.init_cache(2, S_MAX))
    before = ops.dispatch_counts()["flash_attention"]
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.from_numpy(tokens)},
        tmodel.init_cache(2, S_MAX))
    used = ops.dispatch_counts()["flash_attention"] - before
    assert used == (tmodel.cfg.num_layers if use_kernels else 0)
    _close(tlogits, jlogits)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["step"] == int(jcache["step"]) == 13


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
    for _ in range(2):
        jlogits, jcache = jax.jit(jmodel.decode_step)(
            jax_params, jcache, jnp.asarray(nxt))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(nxt))
        _close(tlogits, jlogits)
        nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["step"] == int(jcache["step"]) == 11


def test_decode_step_paged_matches_reference(jax_params):
    jmodel, tmodel, tparams = _pair(jax_params)
    cfg = tmodel.cfg
    P, T = 10, 8
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((P, L, 2, T, KV, hd)).astype(np.float32)
    table = np.asarray([[4, 1, 7, -1], [0, -1, -1, -1], [2, 9, -1, -1]],
                       np.int32)
    lengths = np.asarray([19, 8, 15], np.int32)
    table[1, 1] = 3        # row 1 sits on a page boundary: its tail page
    token = rng.integers(0, 128, (3, 1)).astype(np.int32)
    jlogits, jpool = jax.jit(jmodel.decode_step_paged)(
        jax_params, jnp.asarray(pool), jnp.asarray(table),
        jnp.asarray(lengths), jnp.asarray(token))
    tpool = torch.from_numpy(pool.copy())
    before = ops.dispatch_counts()["paged_attention_decode"]
    tlogits, out_pool = tmodel.decode_step_paged(
        tparams, tpool, torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(token))
    assert ops.dispatch_counts()["paged_attention_decode"] - before == L
    assert out_pool is tpool                       # updated in place
    _close(tlogits, jlogits)
    jpool = np.asarray(jpool)
    for b, n in enumerate(lengths):
        tail, off = table[b, n // T], n % T
        _close(tpool[tail, :, :, off], jpool[tail, :, :, off])
    # nothing but the tail slots changed
    changed = np.zeros(pool.shape, bool)
    for b, n in enumerate(lengths):
        changed[table[b, n // T], :, :, n % T] = True
    np.testing.assert_array_equal(tpool.numpy()[~changed], pool[~changed])
    np.testing.assert_array_equal(jpool[~changed], pool[~changed])


def test_paged_and_dense_decode_agree(jax_params):
    """Within the port: one paged step over a pool holding a prefilled
    prompt gives the dense decode step's logits."""
    _, tmodel, tparams = _pair(jax_params)
    cfg = tmodel.cfg
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (1, 11)).astype(np.int32))
    _, cache = tmodel.prefill(tparams, {"tokens": tokens},
                              tmodel.init_cache(1, S_MAX))
    T = 4
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    pool = torch.zeros((4, L, 2, T, KV, hd))
    kv = torch.stack([cache["k"][:, 0, :12], cache["v"][:, 0, :12]], dim=1)
    pool[:3] = kv.reshape(L, 2, 3, T, KV, hd).permute(2, 0, 1, 3, 4, 5)
    pool = pool[[2, 0, 1, 3]]            # pages out of order in the pool
    table = torch.tensor([[1, 2, 0, -1]], dtype=torch.int32)
    token = torch.tensor([[9]], dtype=torch.int32)
    plog, _ = tmodel.decode_step_paged(tparams, pool, table,
                                       torch.tensor([11], dtype=torch.int32),
                                       token)
    dlog, _ = tmodel.decode_step(tparams, cache, token)
    torch.testing.assert_close(plog, dlog, rtol=TOL, atol=TOL)
