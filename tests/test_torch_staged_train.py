"""The staged train step (``train.staged.StagedTrainStep`` over
``train.loop.make_train_step_``) against the eager step.

On the CPU the launcher's staged path runs the static step without a
graph: the same static buffers, the same in-place updates.  Tolerances,
and why:
  * ``adamw_update_`` and ``ef_compress_tree_`` against their functional
    twins: bit for bit (the in-place AdamW and error feedback compute the
    functional expressions, then copy);
  * the captured step on the card against the eager launcher: losses
    within 1e-5 relative.
The launcher's matrix over five reduced configs (staged against eager
and the reference) is in ``tests/train_launcher_cases.py``, run one
config a file by ``tests/test_torch_train_launcher_*.py``.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import get_config
from repro_torch.core import offload
from repro_torch.data.pipeline import DataConfig, make_dataset
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import ef_compress_tree, ef_compress_tree_
from repro_torch.train.loop import make_train_step_, opt_state_init
from repro_torch.train.staged import OUTPUTS, StagedTrainStep

ARCHS = ("qwen2-1.5b", "rwkv6-7b", "dbrx-132b", "hymba-1.5b",
         "seamless-m4t-large-v2")
ARCH = "qwen2-1.5b"
LOSS_TOL = 1e-5
LR, SEQ = 1e-3, 32


def _clone(tree):
    return tree_map(torch.clone, tree)


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ launcher
def test_staged_launcher_updates_the_params_it_is_given():
    """The staged run's params are the tensors it was given, updated in
    place; the eager run's are new."""
    kw = dict(steps=2, global_batch=4, seq_len=16, verbose=False,
              device="cpu", compress_grads=True, offload_opt=True)
    model = build_model(get_config(ARCH).reduced(), Flags(remat=False),
                        device="cpu")
    init = model.init(torch.Generator().manual_seed(0))
    start = _clone(init)
    out = train.run(ARCH, init_params=init, **kw)
    assert all(a is b for a, b in zip(tree_leaves(out["params"]),
                                      tree_leaves(init)))
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(init), tree_leaves(start)))
    eager = train.run(ARCH, init_params=start, staged=False, **kw)
    assert not any(a is b for a, b in zip(tree_leaves(eager["params"]),
                                          tree_leaves(start)))


# ------------------------------------------------------------ optimizer
def _tree(rng, dtype):
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return {"w": t(8, 16), "b": {"s": t(16), "u": t(3, 4, 5)}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_place_is_bit_identical(dtype):
    """Four steps of ``adamw_update_`` against ``adamw_update`` on the same
    gradients (clipped: their norm exceeds ``grad_clip``): params, m, v,
    master, count, lr and the gradient norm equal bit for bit, and every
    tensor updated keeps its storage."""
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    fparams, fstate = params, adamw.adamw_init(params)
    iparams = _clone(params)
    istate = adamw.adamw_init(iparams)
    ptrs = [l.data_ptr() for l in tree_leaves(iparams) + tree_leaves(istate)]
    for _ in range(4):
        grads = _tree(rng, dtype)
        fparams, fstate, fm = adamw.adamw_update(cfg, grads, fstate,
                                                 fparams)
        im = adamw.adamw_update_(cfg, grads, istate, iparams)
        _assert_bitwise(iparams, fparams)
        _assert_bitwise(istate, fstate)
        assert torch.equal(im["lr"], fm["lr"])
        assert torch.equal(im["grad_norm"], fm["grad_norm"])
        assert float(fm["grad_norm"]) > cfg.grad_clip
    assert int(istate["count"]) == 4
    assert [l.data_ptr() for l in tree_leaves(iparams)
            + tree_leaves(istate)] == ptrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ef_compress_tree_in_place_is_bit_identical(dtype):
    """``ef_compress_tree_`` writes ``ef_compress_tree``'s residual into
    the error tree and returns its decompressed updates, bit for bit; the
    gradients are left as they were."""
    rng = np.random.default_rng(1)
    grads = _tree(rng, dtype)
    err = tree_map(lambda t: t.float() * 1e-3, _tree(rng, torch.float32))
    fd, fe = ef_compress_tree(grads, err)
    kept, ierr = _clone(grads), _clone(err)
    ptrs = [l.data_ptr() for l in tree_leaves(ierr)]
    idec = ef_compress_tree_(grads, ierr)
    _assert_bitwise(idec, fd)
    _assert_bitwise(ierr, fe)
    _assert_bitwise(grads, kept)
    assert [l.data_ptr() for l in tree_leaves(ierr)] == ptrs


# ------------------------------------------------------------ staged step
def _staged_step(arch=ARCH, accum=2, compress=True, device="cpu"):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, Flags(remat=False, attn_chunk=16),
                        device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    state = opt_state_init(params, compress)
    data = make_dataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch(i).items()} for i in range(3)]
    step_ = make_train_step_(model, adamw.AdamWConfig(lr=LR), accum,
                             compress)
    return StagedTrainStep(step_, batches[0], device=device), params, \
        state, batches


def test_params_and_state_keep_their_addresses():
    """Every param and state tensor, and the static outputs, keep their
    storage across steps; each CPU step runs the static step (mode
    ``eager``) and advances the count in place."""
    staged, params, state, batches = _staged_step()
    leaves = tree_leaves(params) + tree_leaves(state)
    ptrs = [l.data_ptr() for l in leaves]
    outs = {k: v.data_ptr() for k, v in staged.outputs.items()}
    for i, batch in enumerate(batches):
        out, mode = staged(params, state, batch)
        assert mode == "eager" and out is staged.outputs
        assert [l.data_ptr() for l in tree_leaves(params)
                + tree_leaves(state)] == ptrs
        assert {k: v.data_ptr() for k, v in out.items()} == outs
        assert int(state["count"]) == i + 1
        assert np.isfinite(float(out["loss"]))
    assert staged.stats()["eager_calls"] == len(batches)


@pytest.mark.parametrize("fresh", ["params", "opt_state"])
def test_a_call_with_fresh_tensors_raises(fresh):
    """The static step's params and state are fixed at the first call: a
    call with a fresh params tree (or state tree) raises."""
    staged, params, state, batches = _staged_step()
    staged(params, state, batches[0])
    args = {"params": params, "opt_state": state}
    args[fresh] = _clone(args[fresh])
    with pytest.raises(ValueError, match="in place"):
        staged(args["params"], args["opt_state"], batches[1])


def test_a_batch_of_another_shape_raises():
    staged, params, state, batches = _staged_step()
    half = {k: v[:2] for k, v in batches[0].items()}
    with pytest.raises(ValueError, match="static buffer"):
        staged(params, state, half)


def test_page_moves_leave_cpu_tensors_where_they_are():
    """On the CPU (modelling mode) ``page_in`` returns the parked leaves
    themselves and ``page_out`` copies nothing."""
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2)}}
    live = offload.page_in(tree)
    assert all(x is y for x, y in zip(tree_leaves(live), tree_leaves(tree)))
    offload.page_out(live, tree)
    assert torch.equal(tree["a"], torch.ones(3))


class _HostDataRefused(TorchFunctionMode):
    """Raises at a torch function that builds a tensor from host data
    (``torch.tensor`` and kin copy it to the device: a pageable copy,
    which a CUDA graph capture refuses) or is given a tensor that is not
    on ``meta``."""

    BUILDERS = (torch.tensor, torch.as_tensor, torch.from_numpy)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BUILDERS:
            raise RuntimeError(f"{func.__name__} copies host data")
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor) and a.device.type != "meta":
                raise RuntimeError(f"{func} given a {a.device} tensor")
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_step_reads_no_value_on_the_host(arch):
    """``make_train_step_`` on ``meta`` params, state, batch and outputs,
    accumulating over two microbatches with compression: a meta tensor
    has no values, so a read on the host (``int()``, ``.item()``, a
    branch on a tensor) raises, and no tensor is built from host data.
    The step runs and leaves every leaf where it was."""
    _step_on_meta(arch)


class _PagingHostStreams(offload.HostStreams):
    """Host streams on ``meta`` that page every leaf: the streamed page
    moves allocate and copy, on tensors without values."""

    def moves(self, leaf):
        return True


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_step_reads_no_value_on_the_host(arch):
    """The same for the streamed schedule, every leaf paged in and out
    (fresh ``meta`` device copies) under the refusal mode."""
    _step_on_meta(arch, _PagingHostStreams("meta"))


def _step_on_meta(arch, streams=None):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, Flags(remat=False, attn_chunk=SEQ),
                        device="cpu")
    params = model.abstract_params()
    state = opt_state_init(params, True)
    meta = lambda *s, dtype=torch.int32: torch.empty(s, dtype=dtype,
                                                     device="meta")
    batch = {"tokens": meta(4, SEQ), "labels": meta(4, SEQ)}
    if cfg.encoder_decoder:
        batch["src_emb"] = meta(4, SEQ, cfg.d_model, dtype=dtype_of(cfg))
    outs = {k: meta(dtype=torch.float32) for k in OUTPUTS}
    leaves = [l.data_ptr() for l in tree_leaves(params) + tree_leaves(state)]
    with pytest.raises(RuntimeError):
        int(state["count"])
    step_ = make_train_step_(model, adamw.AdamWConfig(), 2, True,
                             streams=streams)
    with _HostDataRefused():
        got = step_(params, state, batch, outs)
    assert got is outs and all(v.device.type == "meta" and v.shape == ()
                               for v in outs.values())
    assert [l.data_ptr() for l in tree_leaves(params)
            + tree_leaves(state)] == leaves


def test_the_refusal_mode_catches_a_host_copy():
    """The mode above raises where ``torch.tensor`` builds a scalar for
    the device (the pageable copy a capture refuses), and lets a device
    fill pass."""
    with _HostDataRefused():
        torch.full((), 0.9, dtype=torch.float32, device="meta")
        with pytest.raises(RuntimeError, match="host data"):
            torch.tensor(0.9, dtype=torch.float32, device="meta")


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_train_step_matches_eager_on_the_card(cuda_device):
    """On the card: step 0 eager, step 1 captured, the rest replayed, the
    state paged through pinned host memory inside the graph; losses
    within LOSS_TOL of the eager launcher's."""
    kw = dict(steps=5, global_batch=4, seq_len=SEQ, verbose=False,
              compress_grads=True, grad_accum=2, offload_opt=True,
              device=cuda_device)
    staged = train.run(ARCH, **kw)
    eager = train.run(ARCH, staged=False, **kw)
    assert [r["mode"] for r in staged["step_log"]] == \
        ["eager", "capture", "replay", "replay", "replay"]
    np.testing.assert_allclose(staged["losses"], eager["losses"],
                               rtol=LOSS_TOL)
    n = staged["state_bytes"]
    for rec in staged["step_log"]:
        assert rec["parked_tiers"] == [offload.PINNED_HOST]
        assert rec["moved"] == {"to_device": n, "to_host": n}
        assert rec["device_bytes"] < n
    assert staged["staged"]["captures"] == 1
    assert staged["staged"]["pool_bytes"] > 0


@pytest.mark.cuda
def test_a_host_sync_in_the_train_step_raises_at_capture(cuda_device,
                                                         monkeypatch):
    """Capture refuses a host sync inside the step: the first step runs
    eagerly, the second captures, and the launcher raises there and runs
    no eager step in its place."""
    calls = []
    make = train.make_train_step_

    def syncing(*a, **k):
        step_ = make(*a, **k)

        def step(params, opt_state, batch, out, clock=None):
            calls.append(torch.cuda.is_current_stream_capturing())
            int(batch["tokens"].sum())              # a host sync
            return step_(params, opt_state, batch, out, clock)
        return step

    monkeypatch.setattr(train, "make_train_step_", syncing)
    with pytest.raises(RuntimeError):
        train.run(ARCH, steps=3, global_batch=4, seq_len=SEQ,
                  verbose=False, device=cuda_device)
    assert calls == [False, True]
