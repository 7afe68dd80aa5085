"""The port's training objective against ``repro`` on every reduced config:
``Model.loss`` and its gradients, the chunked cross-entropy, the
teacher-forced decoder, and activation checkpointing (``_remat``).

Params come from the reference's ``Model.init(jax.random.key(0))`` and
reach the port through ``interop.params_from_numpy``; tokens, labels and
source embeddings are made with numpy from a seed.  Tolerances (f32): the
loss within 1e-5 relative; each gradient leaf within 1e-4 of that leaf's
largest magnitude in the reference (the two packages sum the same products
in different orders, and a backward pass sums over more of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models.flags import Flags as JFlags
from repro.models.layers import chunked_softmax_xent as jxent
from repro_torch.configs.base import MOE, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import build_model
from repro_torch.models import encdec
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.flags import Flags
from repro_torch.models.layers import chunked_softmax_xent
from repro_torch.models.zoo import AUX_LOSS_WEIGHT
from repro_torch.train.loop import value_and_grad

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S, S_SRC = 2, 32, 24
#: one config per block type, and the encoder-decoder
REMAT_ARCHS = ("qwen2-1.5b", "dbrx-132b", "hymba-1.5b", "rwkv6-7b",
               "seamless-m4t-large-v2")


def _items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.encoder_decoder:
        batch["src_emb"] = rng.normal(
            size=(B, S_SRC, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch, **flags):
    """(reference model, its params, port model, the same params)."""
    jmodel = jbuild_model(jget_config(arch).reduced(), JFlags(**flags))
    jparams = jmodel.init(jax.random.key(0))
    tmodel = build_model(get_config(arch).reduced(), Flags(**flags),
                         device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jmodel, jparams, tmodel, tparams


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _smallest_router_margin(margins):
    """Wrap the port's ``moe.route`` to record, per router call, the
    smallest gap between the k-th and (k+1)-th router logit (where a flip
    of routing could start); returns the wrapped function."""
    route = moe_mod.route

    def recording(p, cfg, xt):
        out = route(p, cfg, xt)
        top = torch.topk(out[0], cfg.top_k + 1, dim=-1).values
        gap = torch.min(top[..., -2] - top[..., -1]).detach()
        margins.append(float(gap))
        return out
    return recording


@pytest.mark.parametrize("arch", list_configs())
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad(model.loss)``; each gradient keeps its
    parameter's dtype, as JAX's does."""
    jmodel, jparams, tmodel, tparams = _pair(arch, remat=False)
    batch = _batch(tmodel.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    margins = []
    if tmodel.cfg.block_type == MOE:
        monkeypatch.setattr(moe_mod, "route",
                            _smallest_router_margin(margins))
    loss, grads = value_and_grad(tmodel, tparams, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    jflat = dict(_items(jax.tree_util.tree_map(np.asarray, jgrads)))
    tflat = dict(_items(grads))
    assert sorted(tflat) == sorted(jflat)
    for key, g in tflat.items():
        want = jflat[key]
        assert g.dtype == dict(_items(tparams))[key].dtype
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=key)
    if margins:
        # routing ties would make the comparison a coin toss: the smallest
        # margin stays well clear of the float32 noise between packages
        print(f"{arch}: smallest router margin {min(margins):.3e} over "
              f"{len(margins)} router calls")
        assert min(margins) > 1e-6


def test_moe_loss_adds_the_weighted_aux_loss(monkeypatch):
    """The MoE aux loss enters with weight 0.01: the loss moves by
    0.01 * (aux' - aux) when the aux loss is replaced."""
    _, _, tmodel, tparams = _pair("dbrx-132b", remat=False)
    batch = _torch_batch(_batch(tmodel.cfg))
    with torch.no_grad():
        base = float(tmodel.loss(tparams, batch))
        apply = moe_mod.moe_apply

        def plus_one(*args, **kwargs):
            y, aux = apply(*args, **kwargs)
            return y, aux + 1.0
        monkeypatch.setattr(moe_mod, "moe_apply", plus_one)
        moved = float(tmodel.loss(tparams, batch))
    L = tmodel.cfg.num_layers
    assert AUX_LOSS_WEIGHT == 0.01
    assert moved - base == pytest.approx(AUX_LOSS_WEIGHT * L, rel=1e-4)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunked_softmax_xent_matches_reference(chunk):
    """Any chunk gives the reference's mean token cross-entropy and the
    unchunked one; S must be a whole number of chunks."""
    rng = np.random.default_rng(chunk)
    x = rng.normal(size=(3, 32, 16)).astype(np.float32)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 32)).astype(np.int32)
    want = jxent(lambda xc: xc @ jnp.asarray(table).T, jnp.asarray(x),
                 jnp.asarray(labels), chunk=chunk, unroll=False)
    tt = torch.from_numpy(table)
    got = chunked_softmax_xent(lambda xc: xc @ tt.T, torch.from_numpy(x),
                               torch.from_numpy(labels), chunk=chunk,
                               unroll=False)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    whole = torch.nn.functional.cross_entropy(
        (torch.from_numpy(x) @ tt.T).reshape(-1, 40),
        torch.from_numpy(labels).reshape(-1).long())
    np.testing.assert_allclose(float(got), float(whole), rtol=LOSS_TOL)
    with pytest.raises(AssertionError):
        chunked_softmax_xent(lambda xc: xc @ tt.T, torch.from_numpy(x),
                             torch.from_numpy(labels), chunk=5)


def test_decode_train_matches_reference():
    """The teacher-forced decoder of reduced seamless-m4t-large-v2 over a
    given encoder output."""
    _, jparams, tmodel, tparams = _pair("seamless-m4t-large-v2", remat=False)
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    tgt = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, S_SRC, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, t, e: jencdec.decode_train(
        p, jget_config(cfg.name).reduced(), t, e, JFlags(remat=False)))(
        jparams["trunk"], jnp.asarray(tgt), jnp.asarray(enc))
    with torch.no_grad():
        got = encdec.decode_train(tparams["trunk"], cfg,
                                  torch.from_numpy(tgt),
                                  torch.from_numpy(enc), tmodel.flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


class _CountMatmuls(TorchDispatchMode):
    """Counts the ``aten.mm`` calls that reach it (forward, recompute and
    backward alike)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _loss_grads_and_mms(arch, tparams, batch, **flags):
    tmodel = build_model(get_config(arch).reduced(), Flags(**flags),
                         device="cpu")
    with _CountMatmuls() as counter:
        loss, grads = value_and_grad(tmodel, tparams, batch)
    return loss, grads, counter.mm


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_matches_no_remat(arch, policy):
    """Both policies give the loss and gradients of ``remat=False`` (the
    recomputation repeats the same operations, so the results are equal
    bit for bit).  ``"nothing"`` recomputes the blocks' matmuls in the
    backward pass; ``"dots"`` keeps their outputs, so it runs exactly as
    many ``aten.mm`` as no remat at all."""
    _, _, _, tparams = _pair(arch, remat=False)
    batch = _torch_batch(_batch(get_config(arch).reduced()))
    loss0, grads0, mm0 = _loss_grads_and_mms(arch, tparams, batch,
                                             remat=False)
    loss, grads, mm = _loss_grads_and_mms(arch, tparams, batch, remat=True,
                                          remat_policy=policy)
    assert float(loss) == float(loss0)
    for (key, g), (_, g0) in zip(_items(grads), _items(grads0)):
        assert torch.equal(g, g0), key
    if policy == "dots":
        assert mm == mm0
    else:
        assert mm > mm0


def test_remat_is_a_no_op_without_grad(monkeypatch):
    """Serving runs under the default flags (``remat=True``): without grad
    mode no checkpoint is taken and the forward pass is unchanged."""
    _, _, tmodel, tparams = _pair("seamless-m4t-large-v2", remat=True)
    batch = _torch_batch(_batch(tmodel.cfg))
    off = build_model(tmodel.cfg, Flags(remat=False), device="cpu")
    with torch.no_grad():
        b = off.loss(tparams, batch)

    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint taken without grad mode")
    monkeypatch.setattr(transformer.ckpt, "checkpoint", refuse)
    with torch.no_grad():
        a = tmodel.loss(tparams, batch)
    assert float(a) == float(b)
    with pytest.raises(AssertionError, match="without grad mode"):
        tmodel.loss(tparams, batch)


class _FakeCudaTensor:
    """Just enough of a CUDA tensor to reach a dispatcher's card branch."""
    is_cuda = True

    def __init__(self, requires_grad):
        self.requires_grad = requires_grad


@pytest.mark.parametrize("name,call,kernel_mod,kernel", [
    ("flash_attention", lambda t: ops.flash_attention(t, t, t), fa,
     "flash_attention_cuda"),
    ("rwkv6_scan", lambda t: ops.rwkv6_scan(t, t, t, t, t, t), rw,
     "rwkv6_scan_cuda"),
    ("paged_attention_decode",
     lambda t: ops.paged_attention_decode(t, t, t, t, t), pa,
     "paged_attention_cuda"),
])
def test_cuda_branch_refuses_autograd(monkeypatch, name, call, kernel_mod,
                                      kernel):
    """On the card each dispatcher refuses an input that autograd would
    have to differentiate through the kernel, naming the plain version and
    the ``use_kernels=False`` training path; serving (nothing requires
    grad, or no grad mode) reaches the kernel as before."""
    launched = []
    monkeypatch.setattr(kernel_mod, kernel,
                        lambda *a, **k: launched.append(a) or "out")
    with pytest.raises(RuntimeError, match="use_kernels=False") as err:
        call(_FakeCudaTensor(requires_grad=True))
    assert "plain" in str(err.value) and name in str(err.value)
    assert launched == []
    assert call(_FakeCudaTensor(requires_grad=False)) == "out"
    with torch.no_grad():
        assert call(_FakeCudaTensor(requires_grad=True)) == "out"
    assert len(launched) == 2


def test_refuse_autograd_on_real_tensors():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="rwkv6_scan_plain"):
        ops.refuse_autograd("rwkv6_scan", "rwkv6_scan_plain", x)
    ops.refuse_autograd("rwkv6_scan", "rwkv6_scan_plain", x.detach())
    with torch.no_grad():
        ops.refuse_autograd("rwkv6_scan", "rwkv6_scan_plain", x)


def test_training_never_reaches_a_kernel():
    """The launcher's flags (``use_kernels=False``, as the reference's)
    keep a whole training step off every dispatcher with a kernel."""
    from repro_torch.launch import train
    before = ops.dispatch_counts()
    for arch in ("qwen2-1.5b", "rwkv6-7b"):
        train.run(arch, steps=1, global_batch=2, seq_len=16, device="cpu",
                  verbose=False)
    after = ops.dispatch_counts()
    assert {k: after[k] - before[k] for k in after
            if k != "ssd_scan"} == {"flash_attention": 0,
                                    "paged_attention_decode": 0,
                                    "rwkv6_scan": 0, "expert_ffn": 0,
                                    "mla_decode": 0}
