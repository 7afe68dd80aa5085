"""The reference's last public names in the port, each held against the
reference on seeded inputs, and the training example's twin.

Tolerances: ``layer_norm`` within 1e-6 in float32 and one bfloat16 step
(1e-2) in bfloat16; ``scan_layers`` within 1e-6 (float32 sums in the same
order); ``causal_mask``, ``batch_sharding``'s shard shapes,
``move_page``'s pools and ``layer_init``'s tree exactly.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as jget_config
from repro.core.offload import TierExecutor as JTierExecutor
from repro.models import layers as jlayers
from repro.models import scan_utils as jscan
from repro.models import transformer as jtransformer
from repro.sharding import batch_sharding as jbatch_sharding
from repro_torch.configs import base as config_base
from repro_torch.configs.base import get_config
from repro_torch.core import TierExecutor, offload
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import layers, scan_utils, transformer
from repro_torch.sharding import batch_sharding
from stream_recorder import Recorder

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ move_page
def test_move_page_matches_reference():
    """Pages moved between two pools, in both directions, leave both
    packages' pools equal (modelling mode on both sides)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 3, 2)).astype(np.float32)
    b = rng.standard_normal((5, 3, 2)).astype(np.float32)
    jex, tex = JTierExecutor(lmb_memory_kind="device"), TierExecutor("cpu")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    for src, s, dst, d in (("a", 1, "b", 4), ("b", 0, "a", 3),
                           ("a", 3, "a", 0)):
        jp = {"a": ja, "b": jb}
        tp = {"a": ta, "b": tb}
        new = jex.move_page(jp[src], s, jp[dst], d)
        ja, jb = (new, jb) if dst == "a" else (ja, new)
        assert tex.move_page(tp[src], s, tp[dst], d) is tp[dst]
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_move_page_through_the_copy_streams(monkeypatch):
    """With the LMB pool paged (a recorder as the copy streams), a move
    out of it is an H2D then a device write, a move into it a D2H, and
    the pools end as the reference's."""
    rng = np.random.default_rng(1)
    lmb = rng.standard_normal((4, 6)).astype(np.float32)
    onboard = rng.standard_normal((2, 6)).astype(np.float32)
    rec = Recorder()
    monkeypatch.setattr(offload, "copy_streams", lambda device: rec)
    tex = TierExecutor("cpu")
    tl, to = torch.from_numpy(lmb.copy()), torch.from_numpy(onboard.copy())
    rec.paged = lambda t: t is tl
    tex.move_page(tl, 2, to, 0)
    tex.move_page(to, 1, tl, 3)
    jex = JTierExecutor(lmb_memory_kind="device")
    jl, jo = jnp.asarray(lmb), jnp.asarray(onboard)
    jo = jex.move_page(jl, 2, jo, 0)
    jl = jex.move_page(jo, 1, jl, 3)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert [o["stream"] for o in rec.log if o["kind"] == "copy"] == \
        ["h2d", "d2h"]


# ------------------------------------------------------- batch_sharding
@pytest.fixture
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))])
def test_batch_sharding_matches_reference(_no_group_left, shape, names):
    """Every batch size that divides the batch axes, the data axis alone
    or neither: DTensor's local shape under the port's placements is the
    reference ``NamedSharding``'s shard shape."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    amesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    for batch in (1, 3, 16, 48, 512):
        for extra in (1, 2):
            gshape = (batch,) + (8,) * extra
            want = jbatch_sharding(amesh, batch, extra).shard_shape(gshape)
            local, _ = compute_local_shape_and_global_offset(
                gshape, mesh, batch_sharding(mesh, batch, extra))
            assert tuple(local) == tuple(want), (batch, extra)


# ------------------------------------------------------ layers and init
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jlayers.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, dtype))
    got = layers.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    jinit, init = jlayers.layer_norm_init(32), layers.layer_norm_init(32)
    assert sorted(init) == sorted(jinit) == ["bias", "scale"]
    for k in init:
        assert init[k].dtype == torch.float32
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))


@pytest.mark.parametrize("window", [None, 3])
def test_causal_mask_matches_reference(window):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 12, (2, 5)).astype(np.int32)
    k = rng.integers(-1, 12, (2, 9)).astype(np.int32)
    want = jlayers.causal_mask(jnp.asarray(q), jnp.asarray(k), window)
    got = layers.causal_mask(torch.from_numpy(q), torch.from_numpy(k),
                             window)
    assert got.dtype == torch.bool and tuple(got.shape) == (2, 5, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,cross", [
    ("qwen2-1.5b", False), ("rwkv6-7b", False), ("dbrx-132b", False),
    ("hymba-1.5b", False), ("seamless-m4t-large-v2", True)])
def test_layer_init_builds_the_reference_tree(arch, cross):
    """One layer's params: the reference's ``layer_init`` converted
    through ``params_from_numpy`` and the port's own seeded
    ``layer_init`` are the same tree, leaf shapes and dtypes; the port's
    is one layer of its ``stacked_layers_init``."""
    jp = jtransformer.layer_init(jax.random.key(0),
                                 jget_config(arch).reduced(), cross)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    cfg = get_config(arch).reduced()
    own = transformer.layer_init(torch.Generator().manual_seed(0), cfg,
                                 cross)
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(tparams))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    stacked = transformer.stacked_layers_init(
        torch.Generator().manual_seed(0), cfg, 1, cross)
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(stacked)):
        assert b.shape == (1, *a.shape) and torch.equal(a, b[0])


# ------------------------------------------------------------ scan_layers
@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("with_ys", [True, False])
def test_scan_layers_matches_reference(unroll, with_ys):
    rng = np.random.default_rng(4)
    carry = rng.standard_normal((3, 4)).astype(np.float32)
    xs = {"w": rng.standard_normal((5, 4, 4)).astype(np.float32),
          "b": (rng.standard_normal((5, 4)).astype(np.float32),)}

    def body(mod, c, x):
        c = mod.tanh(c @ x["w"] + x["b"][0])
        return c, ({"sum": c.sum(), "c": c} if with_ys else None)
    jc, jy = jscan.scan_layers(
        lambda c, x: body(jnp, c, x), jnp.asarray(carry),
        jax.tree_util.tree_map(jnp.asarray, xs), unroll)
    tc, ty = scan_utils.scan_layers(
        lambda c, x: body(torch, c, x), torch.from_numpy(carry),
        {"w": torch.from_numpy(xs["w"]),
         "b": (torch.from_numpy(xs["b"][0]),)}, unroll)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    if not with_ys:
        assert ty is None and jy is None
        return
    assert ty["c"].shape == (5, 3, 4) and ty["sum"].shape == (5,)
    for k in ("c", "sum"):
        np.testing.assert_allclose(ty[k].numpy(), np.asarray(jy[k]),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the example
def _example(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "train_offload_torch", ROOT / "examples" / "train_offload_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    # a tiny qwen2-family model under the example's name, unregistered
    # again after the test
    monkeypatch.setattr(ex, "SHAPE", dict(
        ex.SHAPE, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16))
    monkeypatch.setattr(ex, "GLOBAL_BATCH", 2)
    monkeypatch.setattr(ex, "SEQ_LEN", 16)
    monkeypatch.setattr(ex, "CKPT_EVERY", 2)
    get_config("qwen2-1.5b")
    monkeypatch.setitem(config_base._REGISTRY, ex.SHAPE["name"], None)
    return ex


def test_train_offload_example_resumes_on_the_cpu(monkeypatch, tmp_path):
    """The example on the CPU, 5 steps with a checkpoint every 2, killed
    at step 3 (the launcher's failure injector); run again, it resumes at
    step 2 and gives the losses of an uninterrupted run; a third run
    resumes at its last checkpoint, step 4."""
    ex = _example(monkeypatch)
    args = ["--device", "cpu", "--steps", "5", "--ckpt"]
    whole = ex.main(args + [str(tmp_path / "whole")])
    assert whole["steps"] == 5 and all(np.isfinite(whole["losses"]))
    run = ex.run
    monkeypatch.setattr(ex, "run", lambda *a, **k: run(*a, fail_at={3},
                                                       **k))
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        ex.main(args + [str(tmp_path / "killed")])
    monkeypatch.setattr(ex, "run", run)
    resumed = ex.main(args + [str(tmp_path / "killed")])
    assert resumed["steps"] == 3
    assert resumed["losses"] == whole["losses"][2:]
    again = ex.main(args + [str(tmp_path / "killed")])
    assert again["losses"] == whole["losses"][4:]
