"""The port's encoder-decoder family against ``repro`` on
seamless-m4t-large-v2 reduced (2 encoder and 2 decoder layers, d_model 64,
4 heads over 4 KV heads, head_dim 16, GELU), and the full-sequence trunk
(``block_train``/``trunk_train``, which the encoder runs) on the four
decoder block types.

Params come from the reference's ``Model.init(jax.random.key(0))`` and
reach the port through ``interop.params_from_numpy``; source frames and
target tokens are made with numpy from a seed and fed to both.  Tolerance
1e-4 (f32), as in ``test_torch_model.py``: the two packages sum the same
matmuls in different orders.  Token streams must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro.models.flags import Flags as JFlags
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import system_for
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, encdec, frontend, transformer
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine

TOL = 1e-4
ARCH = "seamless-m4t-large-v2"
CACHE_KEYS = ("k", "v", "cross_k", "cross_v")


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH).reduced()
    return jbuild_model(cfg, JFlags(remat=False)).init(jax.random.key(0))


def _port_params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _pair(jax_params, use_kernels=False):
    jmodel = jbuild_model(jget_config(ARCH).reduced(),
                          JFlags(remat=False, use_kernels=use_kernels))
    tmodel = build_model(get_config(ARCH).reduced(),
                         Flags(remat=False, use_kernels=use_kernels),
                         device="cpu")
    return jmodel, tmodel, _port_params(jax_params)


def _close(got, expect):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=TOL, atol=TOL)


def _inputs(seed, B, S_src, S_tgt, D=64):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, S_src, D)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, 128, (B, S_tgt)).astype(np.int32)
    return src, tokens


def test_params_carry_over_key_for_key(jax_params):
    """trunk.enc and trunk.dec (with its cross-attention and norm3) reach
    the port leaf for leaf; the port's own init builds the same tree."""
    _, tmodel, tparams = _pair(jax_params)
    assert set(tparams["trunk"]) == {"enc", "dec"}
    assert {"cross", "norm3"} <= set(tparams["trunk"]["dec"])
    assert "cross" not in tparams["trunk"]["enc"]
    jflat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(jflat) == len(jax.tree_util.tree_leaves(tparams))
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(tparams))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_encoder_matches_reference(jax_params):
    """The encoder: RoPE on its self-attention, not causal."""
    jcfg = jget_config(ARCH).reduced()
    src, _ = _inputs(0, 2, 11, 1)
    want = jax.jit(lambda p, s: jencdec.encode(
        p["trunk"], jcfg, s, JFlags(remat=False)))(jax_params,
                                                   jnp.asarray(src))
    tparams = _port_params(jax_params)
    got = encdec.encode(tparams["trunk"], get_config(ARCH).reduced(),
                        torch.from_numpy(src), Flags(remat=False))
    _close(got, want)
    # not causal: the first frame's output depends on the last frame
    src2 = src.copy()
    src2[:, -1] += 1.0
    got2 = encdec.encode(tparams["trunk"], get_config(ARCH).reduced(),
                         torch.from_numpy(src2), Flags(remat=False))
    assert not torch.allclose(got[:, 0], got2[:, 0])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_cache_match_reference(jax_params, use_kernels):
    """A 7-token target prefix into a cache of 16 over 11 source frames:
    logits, self and cross K/V, ``pos`` (-1 past the prefix) and
    ``step``.  With the kernels on, the decoder's causal self-attention
    goes through flash once a layer and the encoder through none."""
    jmodel, tmodel, tparams = _pair(jax_params, use_kernels)
    src, tokens = _inputs(1, 2, 11, 7)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens),
                     "src_emb": jnp.asarray(src)},
        jmodel.init_cache(2, 16, 11))
    before = ops.dispatch_counts()["flash_attention"]
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.from_numpy(tokens),
                  "src_emb": torch.from_numpy(src)},
        tmodel.init_cache(2, 16, 11))
    used = ops.dispatch_counts()["flash_attention"] - before
    assert used == (tmodel.cfg.num_layers if use_kernels else 0)
    _close(tlogits, jlogits)
    for key in CACHE_KEYS:
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert (tcache["pos"][:, 7:] == -1).all()
    assert tcache["step"] == int(jcache["step"]) == 7


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S_src,S_tgt,C", [(11, 5, 16), (6, 9, 24)])
def test_greedy_decode_matches_reference(jax_params, use_kernels, S_src,
                                         S_tgt, C):
    """8 greedy decode steps after the prefix (S < C, the source longer
    and shorter than the target): logits within 1e-4 every step,
    identical token streams, and the caches at the end."""
    jmodel, tmodel, tparams = _pair(jax_params, use_kernels)
    src, tokens = _inputs(2 + S_src, 2, S_src, S_tgt)
    batch = {"tokens": tokens, "src_emb": src}
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()},
        jmodel.init_cache(2, C, S_src))
    tlogits, tcache = tmodel.prefill(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        tmodel.init_cache(2, C, S_src))
    jstream, tstream = [], []
    step = jax.jit(jmodel.decode_step)
    for _ in range(8):
        _close(tlogits, jlogits)
        jnxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        tnxt = tlogits.argmax(-1)[:, None].to(torch.int32)
        jstream.append(jnxt[:, 0].tolist())
        tstream.append(tnxt[:, 0].tolist())
        jlogits, jcache = step(jax_params, jcache, jnp.asarray(jnxt))
        tlogits, tcache = tmodel.decode_step(tparams, tcache, tnxt)
    _close(tlogits, jlogits)
    assert tstream == jstream
    for key in CACHE_KEYS:
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["step"] == int(jcache["step"]) == S_tgt + 8


def test_prefix_longer_than_the_cache_keeps_its_first_slots(jax_params):
    """S > C: the reference keeps the prefix's first C self K/V (no
    ring), and every slot's position is set; the port does the same."""
    jmodel, tmodel, tparams = _pair(jax_params)
    src, tokens = _inputs(3, 1, 5, 10)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jax_params, {"tokens": jnp.asarray(tokens),
                     "src_emb": jnp.asarray(src)},
        jmodel.init_cache(1, 8, 5))
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.from_numpy(tokens),
                  "src_emb": torch.from_numpy(src)},
        tmodel.init_cache(1, 8, 5))
    _close(tlogits, jlogits)
    for key in CACHE_KEYS:
        _close(tcache[key], jcache[key])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b", "hymba-1.5b",
                                  "rwkv6-7b"])
def test_trunk_train_matches_reference(arch, causal):
    """The full-sequence trunk on every decoder block type (DENSE, MOE,
    HYBRID, RWKV6), causal and not: the hidden states and the summed aux
    loss within 1e-4, and one layer's ``block_train`` alone."""
    jcfg = jget_config(arch).reduced()
    jparams = jbuild_model(jcfg, JFlags(remat=False)).init(jax.random.key(0))
    cfg = get_config(arch).reduced()
    tparams = _port_params(jparams)
    rng = np.random.default_rng(11)
    B, S = 2, 24
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    jflags = JFlags(remat=False)
    jx, jaux = jax.jit(lambda p, x_, q: jtransformer.trunk_train(
        p["trunk"], jcfg, x_, q, jflags, causal=causal))(
            jparams, jnp.asarray(x), jnp.asarray(pos))
    tx, taux = transformer.trunk_train(
        tparams["trunk"], cfg, torch.from_numpy(x), torch.from_numpy(pos),
        Flags(remat=False), causal=causal)
    _close(tx, jx)
    _close(taux, jaux)
    if arch == "dbrx-132b":
        assert float(taux) > 0          # the MoE's load-balancing loss
    layer0 = jax.tree_util.tree_map(lambda a: a[0], jparams["trunk"])
    jy, _ = jtransformer.block_train(layer0, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos), jflags, causal)
    ty, _ = transformer.block_train(
        transformer.layer(tparams["trunk"], 0), cfg, torch.from_numpy(x),
        torch.from_numpy(pos), Flags(remat=False), causal)
    _close(ty, jy)


def test_engine_and_launcher_refuse_the_model(monkeypatch, jax_params,
                                              capsys):
    """The reference engine cannot serve an encoder-decoder: its prefill
    passes only the tokens and ``Model.prefill`` reads ``src_emb`` (probed
    here in its modelling mode).  The port's engine refuses the model
    when it is built, and its launcher exits with the same message."""
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))
    ecfg = dict(decode_slots=2, page_tokens=8, max_seq_len=64,
                onboard_pages=4)
    jeng = JServeEngine(
        jbuild_model(jget_config(ARCH).reduced(), JFlags(remat=False)),
        jax_params, jsystem_for("dev0", pool_gib=1, page_bytes=4096),
        JEngineConfig(**ecfg), device_id="dev0")
    jeng.submit(JSubmitSpec(prompt=np.arange(1, 6, dtype=np.int32),
                            max_new_tokens=2))
    with pytest.raises(KeyError, match="src_emb"):
        jeng.step()

    tmodel = build_model(get_config(ARCH).reduced(), Flags(remat=False),
                         device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder.*src_emb"):
        ServeEngine(tmodel, _port_params(jax_params),
                    system_for("dev0", pool_gib=1, page_bytes=4096),
                    EngineConfig(**ecfg), device_id="dev0", device="cpu")
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(["--arch", ARCH, "--device", "cpu",
                           "--requests", "1"])
    assert "encoder-decoder" in str(exc.value.code)
    assert "src_emb" in str(exc.value.code)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_audio_frames_stub(dtype):
    """[B, S, D] frame embeddings in ``dtype`` on the generator's device,
    N(0, 0.1^2), the same for the same seed."""
    def draw(seed):
        return frontend.audio_frames(torch.Generator().manual_seed(seed), 3,
                                     50, 32, dtype)
    a = draw(0)
    assert a.shape == (3, 50, 32) and a.dtype == dtype
    assert a.device == torch.device("cpu")
    torch.testing.assert_close(a, draw(0), rtol=0, atol=0)
    assert not torch.equal(a, draw(1))
    assert 0.08 < float(a.float().std()) < 0.12


def test_vq_tokenize_stub():
    """grid*grid code ids per image, int32, in [offset, vocab)."""
    def draw(seed):
        return frontend.vq_tokenize(torch.Generator().manual_seed(seed), 2,
                                    8, 8192, image_vocab_offset=4096)
    ids = draw(0)
    assert ids.shape == (2, 64) and ids.dtype == torch.int32
    assert int(ids.min()) >= 4096 and int(ids.max()) < 8192
    assert torch.equal(ids, draw(0)) and not torch.equal(ids, draw(1))
