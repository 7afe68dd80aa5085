"""The port's optimizer, train step, checkpoints, tier moves and training
launcher against ``repro``.

Inputs are made with numpy from a seed; params come from the reference's
``Model.init(jax.random.key(0))`` through ``interop.params_from_numpy``;
the configs are the reduced float32 ones.  Tolerances, and why:
  * ``ef_compress`` on identical inputs: bit for bit (both round half to
    even);
  * one AdamW update on identical inputs: 1e-6 relative (float32 scalars
    on both sides; only the order of a sum differs);
  * train steps and launcher runs: losses within 1e-5 relative, params
    within 1e-4 absolute.  With compression on, a last-bit difference in a
    gradient can move one int8 value by one quantum (``amax / 127``), and
    Adam turns that into a step of up to ``2 * lr`` on that element: there
    every element stays within ``2 * lr`` per step and at most one in a
    thousand leaves 1e-4.
The reference's launcher runs in modelling mode on the CPU
(``backend_memory_kinds`` patched to ``("device",)``: JAX 0.9 refuses its
pinned_host transfers there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.configs.base import get_config as jget_config
from repro.core import DeviceSpec as JDeviceSpec
from repro.core import HostSpec as JHostSpec
from repro.core import LMBSystem as JLMBSystem
from repro.core import SystemSpec as JSystemSpec
from repro.core.offload import nbytes_of as jnbytes_of
from repro.core.pool import OutOfMemory as JOutOfMemory
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro.optim import adamw as jadamw
from repro.optim.compression import ef_compress as jef_compress
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch.configs.base import get_config
from repro_torch.core import (DeviceSpec, HostSpec, LMBSystem, OutOfMemory,
                              SystemSpec)
from repro_torch.core import offload
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.optim import adamw
from repro_torch.optim.compression import (ef_compress, ef_compress_tree,
                                           ef_state_init)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
ADAM_TOL = 1e-6
ARCH = "qwen2-1.5b"


def _items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _np(tree):
    """A tree of either package as {path: float32-or-int numpy array}."""
    out = {}
    for key, leaf in _items(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            a = (leaf.float() if leaf.dtype == torch.bfloat16
                 else leaf).numpy()
        else:
            a = np.asarray(leaf)
            a = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        out[key] = a
    return out


def _ref_params(arch=ARCH, **flags):
    jmodel = jbuild_model(jget_config(arch).reduced(), JFlags(**flags))
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("n,dtype", [(7, np.float32), (256, np.float32),
                                     (4099, np.float32),
                                     (1000, "bfloat16")])
def test_ef_compress_bit_for_bit(n, dtype):
    """Same inputs, same bits: the update (in the gradient's dtype) and
    the float32 residual."""
    rng = np.random.default_rng(n)
    g = (rng.normal(size=n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(
        np.float32)
    err = (rng.normal(size=n) * 1e-2).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jd, je = jef_compress(jg, jnp.asarray(err))
    tg = torch.from_numpy(g)
    if dtype == "bfloat16":
        tg = tg.to(torch.bfloat16)
    td, te = ef_compress(tg, torch.from_numpy(err))
    assert td.dtype == tg.dtype and te.dtype == torch.float32
    np.testing.assert_array_equal(_np({"d": td})["d"], _np({"d": jd})["d"])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_int8_rounds_half_to_even():
    """Values exactly half a quantum apart round to the even level in both
    packages (127 quanta of 1.0: amax 127)."""
    t = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    zero = np.zeros_like(t)
    td, _ = ef_compress(torch.from_numpy(t), torch.from_numpy(zero))
    jd, _ = jef_compress(jnp.asarray(t), jnp.asarray(zero))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td.numpy()[1:],
                                  [0.0, 2.0, 2.0, -0.0, -2.0])


def test_error_feedback_is_unbiased_over_repetition():
    """As the reference's test: biased once, unbiased over 50 rounds."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(256,)).astype(np.float32))}
    err = ef_state_init(g)
    total = torch.zeros_like(g["w"])
    for _ in range(50):
        d, err = ef_compress_tree(g, err)
        total = total + d["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               atol=2e-2)


# ------------------------------------------------------------------ AdamW
def test_schedule_matches_reference():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=7, total_steps=50)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=7, total_steps=50)
    for step in (1, 3, 7, 8, 20, 49, 50, 80):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=ADAM_TOL)


def test_global_norm_sums_in_sorted_key_order():
    """A dict flattens in sorted-key order in JAX, whatever order it was
    built in; the float32 sum depends on the order (2^24 + 1 + 1 is 2^24
    from the left, 2^24 + 2 from the right), and the port's matches."""
    tree = {"c": [1.0], "b": [1.0], "a": [4096.0]}   # squares 1, 1, 2^24
    got = adamw.global_norm({k: torch.tensor(v) for k, v in tree.items()})
    want = jadamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    assert float(got) == float(want) == 4096.0


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype):
    """Four updates from the same gradients: params (in their dtype), m,
    v, master, count and the metrics; clipping engaged (gradient norm
    above 1)."""
    rng = np.random.default_rng(2)
    shapes = {"w": (3, 5), "stack": {"scale": (2, 4)}, "final": (4,)}
    mk = lambda f: {"w": f(shapes["w"]), "final": f(shapes["final"]),
                    "stack": {"scale": f(shapes["stack"]["scale"])}}
    p0 = mk(lambda s: rng.normal(size=s).astype(np.float32))
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, param_dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p0)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdt), p0)
    jst, tst = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    for _ in range(4):
        g = mk(lambda s: (rng.normal(size=s) * 3).astype(np.float32))
        jp, jst, jm = jadamw.adamw_update(
            jcfg, jax.tree_util.tree_map(jnp.asarray, g), jst, jp)
        tp, tst, tm = adamw.adamw_update(
            cfg, jax.tree_util.tree_map(torch.from_numpy, g), tst, tp)
    assert float(jm["grad_norm"]) > 1.0
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=ADAM_TOL)
    assert int(tst["count"]) == int(jst["count"]) == 4
    assert tst["count"].dtype == torch.int32
    want, got = _np({"p": jp, **jst}), _np({"p": tp, **tst})
    assert sorted(got) == sorted(want)
    for key in want:
        tol = 1e-2 if key.startswith("p/") and param_dtype == "bfloat16" \
            else ADAM_TOL
        np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                   atol=tol, err_msg=key)
    assert all(leaf.dtype == tdt for leaf in adamw.tree_leaves(tp))


def test_weight_decay_goes_where_master_ndim_is_two_or_more():
    """The reference's rule, kept: with layers stacked [L, ...], every
    per-layer norm scale [L, d] and bias [L, d] is decayed too; only the
    unstacked ``final_norm/scale`` [d] is not."""
    _, jparams, tparams = _ref_params()
    # params of ones, so that decay moves every decayed leaf (biases start
    # at zero); zero gradients, so that decay is all that moves them
    jparams = jax.tree_util.tree_map(jnp.ones_like, jparams)
    tparams = jax.tree_util.tree_map(torch.ones_like, tparams)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.5)
    zero_j = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    zero_t = jax.tree_util.tree_map(torch.zeros_like, tparams)
    jnew, _, _ = jadamw.adamw_update(jadamw.AdamWConfig(**cfg), zero_j,
                                     jadamw.adamw_init(jparams), jparams)
    tnew, _, _ = adamw.adamw_update(adamw.AdamWConfig(**cfg), zero_t,
                                    adamw.adamw_init(tparams), tparams)
    moved = lambda a, b: sorted(k for k in a if not np.array_equal(a[k],
                                                                   b[k]))
    jmoved = moved(_np(jparams), _np(jnew))
    tmoved = moved(_np(tparams), _np(tnew))
    assert tmoved == jmoved
    flat = _np(tparams)
    assert tmoved == sorted(k for k, a in flat.items() if a.ndim >= 2)
    assert "final_norm/scale" not in tmoved
    assert {"trunk/norm1/scale", "trunk/norm2/scale",
            "trunk/attn/wq/b"} <= set(tmoved)       # qwen2 has qkv biases


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([4.0, -3.0])}
    state = adamw.adamw_init(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=200)
    for _ in range(150):
        params, state, _ = adamw.adamw_update(
            cfg, {"w": 2 * params["w"]}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


# ------------------------------------------------------------- train step
def _grad_dtypes(monkeypatch, module, seen):
    update = module.adamw_update

    def recording(cfg, grads, state, params):
        seen.append({k: str(g.dtype).replace("torch.", "")
                     for k, g in _items(grads)})
        return update(cfg, grads, state, params)
    monkeypatch.setattr(module, "adamw_update", recording)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_gradient_dtypes_follow_the_reference(monkeypatch, accum, compress):
    """bfloat16 weights: with one microbatch the optimizer sees gradients
    in each parameter's dtype (bf16 weights, f32 norm scales); with two,
    float32 sums; compression returns its input's dtype."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    jmodel = jbuild_model(jcfg, JFlags(remat=False))
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tmodel = build_model(cfg, Flags(remat=False), device="cpu")
    jseen, tseen = [], []
    _grad_dtypes(monkeypatch, jloop, jseen)
    _grad_dtypes(monkeypatch, loop, tseen)
    tok = np.random.default_rng(0).integers(0, 128, (4, 16)).astype(np.int32)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jloop.make_train_step(jmodel, jadamw.AdamWConfig(**ocfg), accum,
                          compress)(
        jparams, jloop.opt_state_init(jparams, compress),
        {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)})
    loop.make_train_step(tmodel, adamw.AdamWConfig(**ocfg), accum,
                         compress)(
        tparams, loop.opt_state_init(tparams, compress),
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)})
    assert tseen == jseen
    kinds = set(tseen[0].values())
    assert kinds == ({"bfloat16", "float32"} if accum == 1 else
                     {"float32"})


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum, compress):
    """Three steps of ``make_train_step`` against the reference's jitted
    step on the same params and batches: losses, gradient norms, params
    and optimizer state."""
    jmodel, jparams, tparams = _ref_params(remat=False)
    tmodel = build_model(get_config(ARCH).reduced(), Flags(remat=False),
                         device="cpu")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jloop.make_train_step(
        jmodel, jadamw.AdamWConfig(**ocfg), accum, compress))
    tstep = loop.make_train_step(tmodel, adamw.AdamWConfig(**ocfg), accum,
                                 compress)
    jopt = jloop.opt_state_init(jparams, compress)
    topt = loop.opt_state_init(tparams, compress)
    rng = np.random.default_rng(3)
    lrs = []
    for _ in range(3):
        tok, lab = (rng.integers(0, 128, (4, 32)).astype(np.int32)
                    for _ in range(2))
        jparams, jopt, jm = jstep(jparams, jopt, {
            "tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
        tparams, topt, tm = tstep(tparams, topt, {
            "tokens": torch.from_numpy(tok),
            "labels": torch.from_numpy(lab)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=LOSS_TOL)
        lrs.append(float(jm["lr"]))
    want, got = _np({"p": jparams, **jopt}), _np({"p": tparams, **topt})
    assert sorted(got) == sorted(want)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel()
                        for k in want if k.startswith("p/")])
    if compress:
        assert d.max() <= 2 * sum(lrs)
        assert np.sum(d > PARAM_TOL) <= 1e-3 * d.size
    else:
        assert d.max() <= PARAM_TOL
    assert int(got["count"]) == 3


# ------------------------------------------------------------ checkpoints
def _ckpt_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 3, 7).to(torch.bfloat16),
                  "n": torch.tensor(5, dtype=torch.int32)}}


def test_checkpoint_roundtrip_keeps_bf16(tmp_path):
    tree = _ckpt_tree()
    ckpt.save_checkpoint(str(tmp_path), 7, {"params": tree})
    assert ckpt.latest_step(str(tmp_path)) == 7
    out, step = ckpt.restore_checkpoint(str(tmp_path), {"params": tree})
    assert step == 7
    for (k, a), (_, b) in zip(_items(out["params"]), _items(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    with np.load(tmp_path / "step_00000007" / "params.npz") as z:
        assert z["b/c"].dtype == np.uint16
        assert str(z["__dtype__/b/c"]) == "bfloat16"
        assert sorted(z.files) == ["__dtype__/b/c", "a", "b/c", "b/n"]


def test_checkpoint_atomicity(tmp_path):
    """A .tmp dir (torn write) must be invisible to latest_step."""
    ckpt.save_checkpoint(str(tmp_path), 1, {"params": {"a": torch.zeros(2)}})
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), {})


def test_async_checkpoint_snapshots_first(tmp_path):
    """The trees are copied before the writer thread starts: changing a
    tensor in place after the call does not reach the file."""
    tree = {"a": torch.ones(128, 128)}
    t = ckpt.save_checkpoint(str(tmp_path), 3, {"params": tree},
                             async_save=True)
    tree["a"].mul_(5)
    t.join()
    assert ckpt.latest_step(str(tmp_path)) == 3
    out, _ = ckpt.restore_checkpoint(str(tmp_path),
                                     {"params": {"a": torch.zeros(128, 128)}})
    assert torch.equal(out["params"]["a"], torch.ones(128, 128))


def test_restore_checks_shapes_and_keys(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 2, {"params": {"a": torch.zeros(3)}})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), {"params": {
            "a": torch.zeros(4)}})
    with pytest.raises(KeyError, match="missing b"):
        ckpt.restore_checkpoint(str(tmp_path), {"params": {
            "b": torch.zeros(3)}})


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint written by the reference restores in the port and one
    written by the port restores in the reference, bf16 included."""
    tree = _ckpt_tree()
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    jckpt.save_checkpoint(str(tmp_path / "j"), 4, {"params": jtree})
    out, step = ckpt.restore_checkpoint(str(tmp_path / "j"),
                                        {"params": tree})
    assert step == 4
    for (k, a), (_, b) in zip(_items(out["params"]), _items(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    ckpt.save_checkpoint(str(tmp_path / "t"), 5, {"params": tree})
    jout, step = jckpt.restore_checkpoint(str(tmp_path / "t"),
                                          {"params": jtree})
    assert step == 5
    for (k, a), (_, b) in zip(_items(jout["params"]), _items(jtree)):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- tier moves
def test_tier_moves_on_the_cpu():
    """A CPU run is modelling mode: the device tier is the only one, a
    move to it leaves tensors where they are, and asking for pinned host
    memory without a card raises rather than leave the state in place."""
    tree = {"m": torch.ones(3, 4), "count": torch.zeros((), dtype=torch.int32),
            "b": {"h": torch.zeros(5, dtype=torch.bfloat16)}}
    assert offload.backend_memory_kinds("cpu") == (offload.DEVICE,)
    assert offload.supports_in_jit_offload() is False
    same = offload.tree_put_tier(tree, offload.DEVICE)
    assert all(a is b for a, b in zip(adamw.tree_leaves(same),
                                       adamw.tree_leaves(tree)))
    assert {offload.tier_of(l) for l in adamw.tree_leaves(same)} == {
        offload.DEVICE}
    with pytest.raises(RuntimeError, match="no pinned host tier"):
        offload.tree_put_tier(tree, offload.PINNED_HOST)
    with pytest.raises(ValueError, match="unknown memory kind"):
        offload.put_tier(tree["m"], "unpinned_host")
    jtree = {"m": jnp.ones((3, 4)), "count": jnp.zeros((), jnp.int32),
             "b": {"h": jnp.zeros((5,), jnp.bfloat16)}}
    assert offload.nbytes_of(tree) == jnbytes_of(jtree) == 48 + 4 + 10


def test_opt_state_matches_reference_structure():
    """``opt_state_init``: the reference's leaves, shapes, dtypes and
    bytes, with and without the error-feedback residual."""
    _, jparams, tparams = _ref_params()
    for compress in (False, True):
        jst = jloop.opt_state_init(jparams, compress)
        tst = loop.opt_state_init(tparams, compress)
        jflat, tflat = dict(_items(jst)), dict(_items(tst))
        assert sorted(jflat) == sorted(tflat)
        for k in jflat:
            assert tuple(tflat[k].shape) == jflat[k].shape
            assert str(tflat[k].dtype).replace("torch.", "") == \
                str(jflat[k].dtype)
        assert offload.nbytes_of(tst) == jnbytes_of(jst)


# ---------------------------------------------------------------- launcher
def test_pool_sized_from_the_state_where_the_reference_runs_out():
    """4.5 GiB of optimizer state: the reference launcher's fixed 4 GiB
    pool raises OutOfMemory on its 17th block (its own package and the
    port's copy of the control plane agree); the port's launcher sizes its
    pool from the state and holds it, and full-width qwen2-1.5b's
    24,702,574,596 B too.  Accounting only: no memory is allocated."""
    state = 4_563_402_752
    for System, Spec, Host, Dev, OOM in (
            (JLMBSystem, JSystemSpec, JHostSpec, JDeviceSpec, JOutOfMemory),
            (LMBSystem, SystemSpec, HostSpec, DeviceSpec, OutOfMemory)):
        ref = System(Spec(expanders=1, pool_gib=4, hosts=(Host("trainer"),),
                          devices=(Dev("tpu0"),)))
        with pytest.raises(OOM, match="quota exceeded"):
            train.alloc_state_handles(ref, "tpu0", state)
        ref.close()
    for nbytes, blocks, gib in ((state, 17, 5),
                                (24_702_574_596, 93, 24), (1, 1, 1)):
        system = train.state_system(nbytes)
        handles = train.alloc_state_handles(system, train.TRAINER_DEVICE,
                                            nbytes)
        assert len(handles) == blocks and system.spec.pool_gib == gib
        assert sum(h.nbytes for h in handles) >= nbytes
        system.close()


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(jtrain, "backend_memory_kinds", lambda: ("device",))
    monkeypatch.setattr(jtrain, "supports_in_jit_offload", lambda: False)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-large-v2"])
def test_launcher_matches_reference_run(modelling_reference, arch):
    """10 steps of ``launch.train.run(device="cpu")`` from the reference's
    initial params, with offload and compression on, give the reference
    launcher's losses and final params (the encoder-decoder with zero
    source embeddings, as the reference feeds it)."""
    kw = dict(steps=10, global_batch=4, seq_len=32, verbose=False,
              offload_opt=True, compress_grads=True)
    ref = jtrain.run(arch, **kw)
    _, _, tparams = _ref_params(arch, remat=False, attn_chunk=32)
    out = train.run(arch, device="cpu", init_params=tparams, **kw)
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_TOL)
    want, got = _np(ref["params"]), _np(out["params"])
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * 1e-3 * 10
    assert np.sum(d > PARAM_TOL) <= 1e-3 * d.size
    assert out["state_bytes"] == jnbytes_of(ref["opt_state"])


def test_loss_decreases():
    out = train.run(ARCH, steps=30, global_batch=4, seq_len=64,
                    device="cpu", verbose=False)
    assert out["final_loss"] < out["first_loss"] - 0.1


def test_restart_after_failure_resumes_and_matches(tmp_path):
    """Crash at step 12, restart from the checkpoint of step 10: the same
    losses and final params as an uninterrupted run."""
    kw = dict(steps=20, global_batch=4, seq_len=32, ckpt_every=10,
              verbose=False, device="cpu", offload_opt=True,
              compress_grads=True)
    ref = train.run(ARCH, **kw)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        train.run(ARCH, ckpt_dir=d, fail_at={12}, **kw)
    assert ckpt.latest_step(d) == 10
    out = train.run(ARCH, ckpt_dir=d, **kw)
    assert out["steps"] == 10
    np.testing.assert_allclose(out["losses"], ref["losses"][10:], rtol=1e-6)
    for (k, a), (_, b) in zip(_items(ref["params"]), _items(out["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_step_log_records_each_stage():
    out = train.run(ARCH, steps=2, global_batch=4, seq_len=16, device="cpu",
                    verbose=False, grad_accum=2, compress_grads=True,
                    offload_opt=True)
    assert [r["step"] for r in out["step_log"]] == [0, 1]
    for rec in out["step_log"]:
        assert sorted(rec["times"]) == ["adamw", "compress", "fwd_bwd",
                                        "page_in", "page_out"]
        assert rec["moved"] == {"to_device": 0, "to_host": 0}
        assert rec["parked_tiers"] == [offload.DEVICE]


def test_launcher_main_on_the_cpu(capsys):
    train.main(["--device", "cpu", "--steps", "2", "--seq-len", "16",
                "--global-batch", "2", "--offload-opt", "--compress-grads"])
    assert "[train] done: loss" in capsys.readouterr().out


def test_launcher_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(ARCH, steps=1)


@pytest.mark.cuda
def test_offload_parks_the_state_in_pinned_memory_on_the_card():
    """On the card: between steps every optimizer leaf is page-locked host
    memory, each step moves the state's bytes both ways, and the losses
    match a run that keeps the state on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (pinned host memory)")
    kw = dict(steps=4, global_batch=4, seq_len=32, verbose=False,
              compress_grads=True, device="cuda")
    on = train.run(ARCH, offload_opt=False, **kw)
    off = train.run(ARCH, offload_opt=True, **kw)
    np.testing.assert_allclose(off["losses"], on["losses"], rtol=1e-6)
    for rec in off["step_log"]:
        assert rec["parked_tiers"] == [offload.PINNED_HOST]
        assert rec["moved"] == {"to_device": off["state_bytes"],
                                "to_host": off["state_bytes"]}
