"""The port's LinkedBuffer, KV store and serving engine against the JAX
reference, on the CPU (modelling mode: both tiers are CPU tensors).

The JAX reference gathers from a ``pinned_host`` pool that this JAX
refuses, so each test that builds a reference buffer patches
``repro.core.offload.backend_memory_kinds`` to report only ``("device",)``
— the reference's own modelling mode.  Nothing in ``repro`` changes.
Engines run with a fixed ``round_time_s`` so the overlap window, and with
it every prefetch decision, is the same on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload
from repro.configs.base import get_config as jget_config
from repro.core import system_for as jsystem_for
from repro.core.buffer import LinkedBuffer as JLinkedBuffer
from repro.models import build_model as jbuild_model
from repro.models.flags import Flags as JFlags
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SubmitSpec as JSubmitSpec
from repro_torch.configs.base import get_config
from repro_torch.core import TierExecutor, system_for
from repro_torch.core.buffer import LinkedBuffer
from repro_torch.core.metrics import GLOBAL_METRICS
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    """tests/conftest.py resets only the reference's GLOBAL_METRICS."""
    GLOBAL_METRICS.reset()
    yield


@pytest.fixture
def modelling_reference(monkeypatch):
    monkeypatch.setattr(repro.core.offload, "backend_memory_kinds",
                        lambda: ("device",))


# ------------------------------------------------------------ LinkedBuffer
def _buffers(compress, onboard=3, page_shape=(2, 4)):
    jbuf = JLinkedBuffer(
        name="buf", device_id="dev0",
        host=jsystem_for("dev0", pool_gib=1, page_bytes=4096).host(),
        page_shape=page_shape, dtype=jnp.float32, onboard_pages=onboard,
        policy="cost", prefetch_depth=2, compress_lmb=compress)
    tbuf = LinkedBuffer(
        name="buf", device_id="dev0",
        host=system_for("dev0", pool_gib=1, page_bytes=4096).host(),
        executor=TierExecutor("cpu"), page_shape=page_shape,
        dtype=torch.float32, onboard_pages=onboard, policy="cost",
        prefetch_depth=2, compress_lmb=compress)
    return jbuf, tbuf


@pytest.mark.parametrize("compress", [False, True])
def test_linked_buffer_matches_reference(modelling_reference, compress):
    """A seeded mix of scalar and batched reads/writes over a buffer four
    times its onboard tier: identical data, tier counters, link bytes and
    page residency (int8 compression of cold pages included)."""
    jbuf, tbuf = _buffers(compress)
    rng = np.random.default_rng(5 + compress)
    n = 12
    jbuf.append_pages(n)
    tbuf.append_pages(n)
    for step in range(60):
        kind = rng.integers(0, 4)
        if kind == 0:
            p = int(rng.integers(0, n))
            d = rng.standard_normal((2, 4)).astype(np.float32)
            jbuf.write(p, jnp.asarray(d))
            tbuf.write(p, torch.from_numpy(d))
        elif kind == 1:
            p = int(rng.integers(0, n))
            np.testing.assert_allclose(tbuf.read(p).numpy(),
                                       np.asarray(jbuf.read(p)),
                                       rtol=1e-6, atol=1e-6)
        elif kind == 2:
            pages = [int(x) for x in rng.integers(0, n, 5)]
            d = rng.standard_normal((5, 2, 4)).astype(np.float32)
            jbuf.write_many(pages, jnp.asarray(d))
            tbuf.write_many(pages, torch.from_numpy(d))
        else:
            pages = [int(x) for x in rng.integers(0, n, 6)]
            np.testing.assert_allclose(tbuf.read_many(pages).numpy(),
                                       np.asarray(jbuf.read_many(pages)),
                                       rtol=1e-6, atol=1e-6)
    tbuf.check_invariants()
    jc = jbuf.metrics.tier("buf", "onboard")
    tc = tbuf.metrics.tier("buf", "onboard")
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    assert tc.misses > 0
    assert tbuf.host.fm.op_bytes() == jbuf.host.fm.op_bytes()
    assert [tbuf.tier_of(p) for p in range(n)] == \
        [jbuf.tier_of(p) for p in range(n)]
    assert tbuf.prefetch_stats() == jbuf.prefetch_stats()


def test_linked_buffer_reads_do_not_alias_pools():
    """torch's ``pool[slot]`` is a view; a read must hand out a copy, or
    a later eviction or write would change data the caller holds."""
    _, tbuf = _buffers(False, onboard=2)
    tbuf.append_pages(4)
    for p in range(4):
        tbuf.write(p, torch.full((2, 4), float(p)))    # pages 0, 1 spill
    held = tbuf.read(3)
    many = tbuf.read_many([0, 3])
    held += 100.0                   # mutate what the caller holds
    many += 100.0
    tbuf.write(3, torch.full((2, 4), -1.0))
    for p in (0, 1, 2):
        torch.testing.assert_close(tbuf.read(p), torch.full((2, 4), float(p)))
    torch.testing.assert_close(tbuf.read(3), torch.full((2, 4), -1.0))
    tbuf.check_invariants()


# ------------------------------------------------------------------ serve
@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config("qwen2-1.5b").reduced()
    return jbuild_model(cfg, JFlags(remat=False)).init(jax.random.key(0))


def _serve_pair(jax_params, prompts, max_new, use_kernels=False, **ecfg):
    cfg_kw = dict(decode_slots=2, max_seq_len=64, page_tokens=8,
                  onboard_pages=8, trace=True,
                  round_time_s=1e-3)
    cfg_kw.update(ecfg)
    jcfg = jget_config("qwen2-1.5b").reduced()
    jeng = JServeEngine(
        jbuild_model(jcfg, JFlags(remat=False, use_kernels=use_kernels)),
        jax_params, jsystem_for("dev0", host_id="h0", pool_gib=1,
                                page_bytes=4096),
        JEngineConfig(**cfg_kw), device_id="dev0")
    teng = ServeEngine(
        build_model(get_config("qwen2-1.5b").reduced(),
                    Flags(remat=False, use_kernels=use_kernels),
                    device="cpu"),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params)),
        system_for("dev0", host_id="h0", pool_gib=1, page_bytes=4096),
        EngineConfig(**cfg_kw), device_id="dev0", device="cpu")
    before = ops.dispatch_counts()["paged_attention_decode"]
    streams = []
    for eng, spec in ((jeng, JSubmitSpec), (teng, SubmitSpec)):
        rids = [eng.submit(spec(prompt=p, max_new_tokens=max_new))
                for p in prompts]
        eng.run(400)
        assert all(eng.requests[r].state == "done" for r in rids)
        streams.append([eng.requests[r].out_tokens for r in rids])
    dispatched = ops.dispatch_counts()["paged_attention_decode"] - before
    return jeng, teng, streams, dispatched


def _assert_same_serving(jeng, teng, streams, dispatched):
    assert streams[1] == streams[0]                  # identical tokens
    jfm, tfm = jeng.kv.buf.host.fm, teng.kv.buf.host.fm
    assert tfm.op_bytes() == jfm.op_bytes()
    jc = jeng.kv.buf.metrics.tier(jeng.kv.buf.name, "onboard")
    tc = teng.kv.buf.metrics.tier(teng.kv.buf.name, "onboard")
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    assert teng.paged_rounds == jeng.paged_rounds > 0
    # the port's paged decode went through the dispatcher every layer of
    # every round
    assert dispatched == teng.paged_rounds * teng.cfg.num_layers

    def xfer_bytes(eng):
        return sum(s.nbytes for s in eng.trace.spans()
                   if s.name == "link.xfer")
    assert xfer_bytes(teng) == xfer_bytes(jeng)
    assert teng.stats()["decode_path"] == "paged"


@pytest.mark.parametrize("use_kernels", [False, True])
def test_serving_matches_reference(modelling_reference, jax_params,
                                   use_kernels):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 100, n).astype(np.int32)
               for n in (5, 13, 20, 9, 17)]
    _assert_same_serving(*_serve_pair(jax_params, prompts, 6,
                                      use_kernels=use_kernels))


def test_serving_spill_matches_reference(modelling_reference, jax_params):
    """The working set far beyond the onboard tier: decode views wave
    through onboard capacity and KV pages cross the LMB link."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 100, 20).astype(np.int32) for _ in range(6)]
    jeng, teng, streams, dispatched = _serve_pair(
        jax_params, prompts, 6, decode_slots=4, onboard_pages=4)
    _assert_same_serving(jeng, teng, streams, dispatched)
    tc = teng.kv.buf.metrics.tier(teng.kv.buf.name, "onboard")
    assert tc.misses > 0
    assert teng.kv.buf.host.fm.op_bytes().get("demand", 0) > 0


def test_dense_and_paged_decode_agree_in_the_port(jax_params):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 100, n).astype(np.int32) for n in (7, 12)]
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jax_params))
    out = []
    for paged in (False, True):
        eng = ServeEngine(
            build_model(get_config("qwen2-1.5b").reduced(),
                        Flags(remat=False), device="cpu"),
            params, system_for("dev0", pool_gib=1, page_bytes=4096),
            EngineConfig(decode_slots=2, max_seq_len=64, page_tokens=8,
                         onboard_pages=8, paged_decode=paged),
            device_id="dev0", device="cpu")
        rids = [eng.submit(SubmitSpec(prompt=p, max_new_tokens=5))
                for p in prompts]
        eng.run(100)
        out.append([eng.requests[r].out_tokens for r in rids])
        assert eng.stats()["decode_path"] == ("paged" if paged else "dense")
    assert out[0] == out[1]
