"""The staged prefill (``serve/staged.py``, :class:`StagedPrefill`) against
the eager port engine and the JAX reference's ``ServeEngine``.

The reference prefills with ``jax.jit(model.prefill)`` at the prompt's
exact length, so it keeps one executable per length; the port keeps one
CUDA graph per length, every one of them writing into the engine's one
static prefill cache, which ``trunk_prefill`` resets and fills in place.
On the CPU (no CUDA graph exists there) the same static token buffer and
cache feed ``Model.prefill`` called directly.  Reduced f32 configs, one
paged (qwen2-1.5b, dbrx-132b with its MoE) and three on the dense slot
path (rwkv6-7b, hymba-1.5b, h2o-danube-3-4b with its ring), served by
the reference, the eager port engine (``staged=False``) and the staged
one, with prompt lengths that recur (each length prefilled a first,
second and third time, a shorter one after a longer), must give the same
greedy streams, link bytes, onboard hits and misses, and prefill logits
within 1e-4 of the reference's.  The static cache must read as fresh
after every prefill: a shorter prompt after a longer one leaves no
position, K/V or state of the longer one behind.  ``Model.prefill`` reads
no tensor value on the host: it runs on ``meta`` tensors, which hold
none.  Modelling mode, as in ``test_torch_serve.py``.

The captured prefill graphs' card tests, which need no JAX, are in
``tests/test_torch_staged_card.py``.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.models import build_model as jbuild_model
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
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve.staged import StagedPrefill

#: paged (DENSE, MOE) and dense slot (RWKV6, HYBRID, DENSE with a window)
ARCHS = ("qwen2-1.5b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
         "h2o-danube-3-4b")
#: 3 decode slots, 5 onboard pages of 8 tokens: slots are reused and the
#: KV spills past the onboard tier
ECFG = dict(decode_slots=3, max_seq_len=64, page_tokens=8, onboard_pages=5,
            round_time_s=1e-3)
#: (prompt length, new tokens): 13 four times, 20 three times, 7 twice;
#: shorter lengths follow longer ones, and 20 passes the reduced window
LOAD = ((13, 4), (20, 5), (13, 3), (7, 4), (20, 3), (13, 5), (7, 2),
        (20, 4), (13, 3))
TOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


@pytest.fixture(scope="module")
def jax_params():
    return {arch: jbuild_model(jget_config(arch).reduced(),
                               JFlags(remat=False)).init(jax.random.key(0))
            for arch in ARCHS}


def _ecfg(arch):
    # the reference serves RWKV6 with kv_prefetch off only: with it on it
    # asks for the tail page of a sequence that holds none
    return dict(ECFG, **({"kv_prefetch": False} if arch == "rwkv6-7b"
                         else {}))


def _port(arch, jax_params, device="cpu"):
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device=device)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_params[arch]), device=device)
    return model, params


def _port_engine(arch, jax_params, device="cpu", **kw):
    model, params = _port(arch, jax_params, device)
    return ServeEngine(model, params,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**_ecfg(arch)), device_id="dev0",
                       device=device, **kw)


def _reference_engine(arch, jax_params):
    return JServeEngine(
        jbuild_model(jget_config(arch).reduced(),
                     JFlags(remat=False, use_kernels=True)),
        jax_params[arch], jsystem_for("dev0", host_id="h0", pool_gib=1,
                                      page_bytes=4096),
        JEngineConfig(**_ecfg(arch)), device_id="dev0")


def _recording(eng):
    """Wrap ``eng``'s prefill to keep each prefill's logits (as numpy);
    returns the list they go into."""
    logits, fn = [], eng._prefill_fn

    def prefill(*args):
        out = fn(*args)
        logits.append(np.array(out[0], dtype=np.float32))
        return out

    eng._prefill_fn = prefill
    return logits


def _serve(eng, spec, load=LOAD):
    """Serve ``load``; returns ((streams, link bytes, (hits, misses)),
    dispatcher calls made, each prefill's logits)."""
    rng = np.random.default_rng(5)
    logits = _recording(eng)
    before = ops.dispatch_counts()
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    seen = (tier.hits, tier.misses)       # the registry is process-wide
    rids = [eng.submit(spec(prompt=rng.integers(1, 100, n).astype(np.int32),
                            max_new_tokens=new)) for n, new in load]
    eng.run(400)
    assert all(eng.requests[r].state == "done" for r in rids)
    used = {k: n - before[k] for k, n in ops.dispatch_counts().items()}
    return (([eng.requests[r].out_tokens for r in rids],
             eng.kv.buf.host.fm.op_bytes(),
             (tier.hits - seen[0], tier.misses - seen[1])), used, logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_prefill_matches_eager_and_reference(modelling_reference,
                                                    jax_params, arch):
    ref, _, ref_logits = _serve(_reference_engine(arch, jax_params),
                                JSubmitSpec)
    eager_eng = _port_engine(arch, jax_params, staged=False)
    staged_eng = _port_engine(arch, jax_params)
    assert eager_eng.staged_prefill is None
    assert isinstance(staged_eng.staged_prefill, StagedPrefill)
    eager, staged = (_serve(e, SubmitSpec) for e in (eager_eng, staged_eng))
    assert staged[0] == eager[0] == ref
    assert staged[1] == eager[1]
    assert len(staged[2]) == len(ref_logits) == len(LOAD)
    for got, want in zip(staged[2], ref_logits):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for got, want in zip(eager[2], staged[2]):
        np.testing.assert_array_equal(got, want)
    if arch != "rwkv6-7b":                  # the KV spills to LMB pages
        assert ref[2][1] > 0 and ref[1].get("demand", 0) > 0
    kernel = "rwkv6_scan" if arch == "rwkv6-7b" else "flash_attention"
    assert staged[1][kernel] == len(LOAD) * staged_eng.cfg.num_layers
    st = staged_eng.staged_prefill.stats()
    assert st["calls"] == {7: 2, 13: 4, 20: 3}
    assert st["eager_calls"] == len(LOAD)
    assert st["captures"] == st["replays"] == 0      # no graph on the CPU


def _fresh(model, params, toks):
    return model.prefill(params, {"tokens": toks},
                         model.init_cache(1, ECFG["max_seq_len"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_static_cache_is_reset_before_every_prefill(jax_params, arch):
    """A 30-token prompt, then a 9-token one, then 20, through one
    :class:`StagedPrefill`: after each, the static cache equals a fresh
    cache's prefill leaf for leaf (``pos`` -1 and K/V zero past the
    prompt, the ring filled as the reference fills it, the recurrent
    states the prompt's), and decoding on from a copy of it gives the
    fresh cache's logits.  Without the reset the 9-token prompt would
    leave the 30-token prompt's positions 9..29 in place, and the
    decode would attend to them."""
    model, params = _port(arch, jax_params)
    staged = StagedPrefill(model.prefill,
                           lambda: model.init_cache(1, ECFG["max_seq_len"]),
                           max_seq_len=ECFG["max_seq_len"], device="cpu")
    rng = np.random.default_rng(9)
    for S in (30, 9, 20):
        toks = torch.from_numpy(rng.integers(1, 100, (1, S)).astype(
            np.int32))
        logits, cache = staged(params, toks)
        assert cache is staged.cache
        want_logits, want = _fresh(model, params, toks)
        torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
        assert cache.keys() == want.keys()
        for key in want:
            assert torch.equal(cache[key], want[key]), (S, key)
        if "pos" in cache:
            C = cache["pos"].shape[1]
            assert (cache["pos"][0, min(S, C):] == -1).all()
        copy = {k: v.clone() for k, v in cache.items()}
        tok = torch.tensor([[int(torch.argmax(logits[0]))]],
                           dtype=torch.int32)
        for _ in range(3):
            got, copy = model.decode_step(params, copy, tok)
            exp, want = model.decode_step(params, want, tok)
            torch.testing.assert_close(got, exp, rtol=0, atol=0)
            tok = torch.argmax(got, dim=-1, keepdim=True).to(torch.int32)
    assert staged.stats()["calls"] == {9: 1, 20: 1, 30: 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_reads_no_value_on_the_host(arch):
    """``Model.prefill`` on ``meta`` params, cache and tokens, the kernels'
    dispatchers on: a meta tensor has no values, so a read of one on the
    host (``int()``, ``.item()``, ``.tolist()``, a branch on a tensor)
    raises.  The prefill runs at a length ragged against the scans'
    chunk, gives logits of the right shape and fills the cache it was
    given, leaf by leaf where it was."""
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device="cpu")
    params = model.abstract_params()
    cache = model.init_cache(1, 128, device="meta")
    leaves = {k: v.data_ptr() for k, v in cache.items()}
    tokens = torch.empty((1, 70), dtype=torch.int32, device="meta")
    logits, out = model.prefill(params, {"tokens": tokens}, cache)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (1, model.cfg.padded_vocab)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == \
        leaves


def test_a_prompt_past_the_token_buffer_is_refused(jax_params):
    model, params = _port("qwen2-1.5b", jax_params)
    staged = StagedPrefill(model.prefill, lambda: model.init_cache(1, 16),
                           max_seq_len=16, device="cpu")
    with pytest.raises(ValueError, match="0 < S <= 16"):
        staged(params, torch.ones((1, 17), dtype=torch.int32))
    assert staged.stats()["calls"] == {}
