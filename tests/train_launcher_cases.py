"""The launcher's train matrix, one config at a time: the staged launcher
against the eager one and the reference, and the streamed launcher
against the serial one and the reference, each over accumulation 1/2 x
compression on/off.  ``tests/test_torch_train_launcher_<config>.py``
holds one config each, so that workers running test files whole share
the matrix.  Tolerances, and why:
  * staged against ``staged=False``, and streamed against the serial
    schedule: bit for bit (the in-place AdamW and error feedback compute
    the functional expressions, then copy; the streamed step runs the
    same expressions, each leaf independent, the global norm summed in
    the same order);
  * against the reference's launcher: losses within 1e-5 relative, and
    params as ``tests/test_torch_optim.py`` holds the launcher (every
    element within Adam's ``2 * lr`` a step, at most one in a thousand
    past 1e-4: with compression a last-bit difference in a gradient can
    move one int8 value by a quantum).
The reduced configs are float32; the reference runs in modelling mode
(``backend_memory_kinds`` patched to ``("device",)``).
"""

import jax
import numpy as np
import torch

import repro.launch.train as jtrain
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train
from repro_torch.optim.adamw import tree_leaves, tree_map
from stream_recorder import Recorder

#: (grad_accum, compress_grads) of every case
MATRIX = [(1, False), (1, True), (2, False), (2, True)]
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STEPS, LR, SEQ = 3, 1e-3, 32


def modelling_reference(monkeypatch):
    monkeypatch.setattr(jtrain, "backend_memory_kinds", lambda: ("device",))
    monkeypatch.setattr(jtrain, "supports_in_jit_offload", lambda: False)


def _np(tree):
    """A float tree of either package as a list of float32 numpy arrays
    in sorted-key order."""
    out = []
    for leaf in (tree_leaves(tree) if isinstance(tree, dict) else tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().float().numpy())
        else:
            out.append(np.asarray(leaf).astype(np.float32))
    return out


def _jleaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _jleaves(tree[k])]
    return [tree]


def _ref_params(arch):
    jmodel = jbuild_model(jget_config(arch).reduced(),
                          JFlags(remat=False, attn_chunk=SEQ))
    jparams = jmodel.init(jax.random.key(0))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_near_reference(losses, params, ref):
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_TOL)
    got, want = _np(params), _np(_jleaves(ref["params"]))
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert d.max() <= 2 * LR * STEPS
    assert np.sum(d > PARAM_TOL) <= 1e-3 * d.size


def _kw(accum, compress):
    return dict(steps=STEPS, global_batch=4, seq_len=SEQ, verbose=False,
                offload_opt=True, compress_grads=compress, grad_accum=accum,
                lr=LR)


def staged_launcher_matches_eager_and_reference(arch, accum, compress):
    """``run(staged=True)`` (the static step, updating in place) gives the
    eager launcher's losses, params and state bit for bit, and the
    reference launcher's losses within LOSS_TOL, with the optimizer state
    offloaded (modelling mode on the CPU)."""
    kw = _kw(accum, compress)
    ref = jtrain.run(arch, **kw)
    init = _ref_params(arch)
    staged = train.run(arch, device="cpu",
                       init_params=tree_map(torch.clone, init), **kw)
    eager = train.run(arch, device="cpu", init_params=init, staged=False,
                      **kw)
    assert staged["losses"] == eager["losses"]
    _assert_bitwise(staged["params"], eager["params"])
    _assert_bitwise(staged["opt_state"], eager["opt_state"])
    assert [r["mode"] for r in staged["step_log"]] == ["eager"] * STEPS
    assert staged["staged"]["eager_calls"] == STEPS
    assert staged["staged"]["captures"] == 0
    _assert_near_reference(staged["losses"], staged["params"], ref)


def streamed_launcher_matches_serial_and_reference(monkeypatch, arch, accum,
                                                   compress):
    """``run(streamed=True)``, the recorder paging every leaf, gives the
    serial schedule's losses, params and state bit for bit, and the
    reference launcher's losses within LOSS_TOL, offload on."""
    kw = _kw(accum, compress)
    ref = jtrain.run(arch, **kw)
    init = _ref_params(arch)
    rec = Recorder()
    monkeypatch.setattr(train, "copy_streams", lambda device: rec)
    streamed = train.run(arch, device="cpu", streamed=True,
                         init_params=tree_map(torch.clone, init), **kw)
    serial = train.run(arch, device="cpu", streamed=False,
                       init_params=init, **kw)
    assert streamed["streamed"] and not serial["streamed"]
    n = len(tree_leaves(streamed["opt_state"]))
    copies = [o for o in rec.log if o["kind"] == "copy"]
    assert len(copies) == 2 * n * STEPS
    assert streamed["losses"] == serial["losses"]
    _assert_bitwise(streamed["params"], serial["params"])
    _assert_bitwise(streamed["opt_state"], serial["opt_state"])
    assert [r["mode"] for r in streamed["step_log"]] == ["eager"] * STEPS
    assert all(set(r["times"]) == {"step"} for r in streamed["step_log"])
    _assert_near_reference(streamed["losses"], streamed["params"], ref)
