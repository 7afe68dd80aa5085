"""The staged paged decode step (``serve/staged.py``) against the eager
port engine and the JAX reference's ``ServeEngine``.

On the CPU the engine's static-buffer path runs with the step called
directly (no CUDA graph exists there): each round's pages are gathered
into the pool buffer, its other inputs copied into the fixed buffers, and
the step reads only those.  Reduced f32
qwen2-1.5b and dbrx-132b, served by the reference (its paged step under
``jax.jit``), the eager port engine (``staged=False``) and the staged
one, must give the same greedy streams, link bytes, onboard hits and
misses, and the same dispatcher calls.  Batch sizes vary from round to
round (requests of different lengths finish at different rounds), so the
step runs at several B.  Modelling mode, as in ``test_torch_serve.py``.

The ``cuda`` tests run the captured graphs on the card: staged against
eager with exact launch counts through replays, and a host sync inside
the step, which must make the engine raise rather than run eagerly.
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
from repro_torch.kernels import cuda_build, ops
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
from repro_torch.serve.staged import StagedStep

ARCHS = ("qwen2-1.5b", "dbrx-132b")
#: decode slots 4, pages of 8 tokens, 5 onboard: the working set spills
ECFG = dict(decode_slots=4, max_seq_len=64, page_tokens=8, onboard_pages=5,
            round_time_s=1e-3)
#: prompt lengths and new tokens: requests finish at different rounds, so
#: the decode batch takes several sizes
LOAD = ((5, 7), (13, 3), (20, 9), (9, 5), (17, 4), (11, 6))


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


def _port_engine(arch, jax_params, device="cpu", **kw):
    model = build_model(get_config(arch).reduced(),
                        Flags(remat=False, use_kernels=True), device=device)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_params[arch]), device=device)
    return ServeEngine(model, params,
                       system_for("dev0", host_id="h0", pool_gib=1,
                                  page_bytes=4096),
                       EngineConfig(**ECFG), device_id="dev0",
                       device=device, **kw)


def _reference_engine(arch, jax_params):
    return JServeEngine(
        jbuild_model(jget_config(arch).reduced(),
                     JFlags(remat=False, use_kernels=True)),
        jax_params[arch], jsystem_for("dev0", host_id="h0", pool_gib=1,
                                      page_bytes=4096),
        JEngineConfig(**ECFG), device_id="dev0")


def _serve(eng, spec):
    """Serve ``LOAD``; returns (streams, link bytes, (hits, misses),
    dispatcher calls made)."""
    rng = np.random.default_rng(7)
    before = ops.dispatch_counts()
    tier = eng.kv.buf.metrics.tier(eng.kv.buf.name, "onboard")
    seen = (tier.hits, tier.misses)       # the registry is process-wide
    rids = [eng.submit(spec(prompt=rng.integers(1, 100, n).astype(np.int32),
                            max_new_tokens=new)) for n, new in LOAD]
    eng.run(400)
    assert all(eng.requests[r].state == "done" for r in rids)
    used = {k: n - before[k] for k, n in ops.dispatch_counts().items()}
    return ([eng.requests[r].out_tokens for r in rids],
            eng.kv.buf.host.fm.op_bytes(),
            (tier.hits - seen[0], tier.misses - seen[1]), used)


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_engine_matches_eager_and_reference(modelling_reference,
                                                   jax_params, arch):
    ref = _serve(_reference_engine(arch, jax_params), JSubmitSpec)[:3]
    eager_eng = _port_engine(arch, jax_params, staged=False)
    staged_eng = _port_engine(arch, jax_params)
    assert eager_eng.staged is None
    assert isinstance(staged_eng.staged, StagedStep)
    eager, staged = (_serve(e, SubmitSpec) for e in (eager_eng, staged_eng))
    assert staged[:3] == eager[:3] == ref
    assert staged[3] == eager[3]
    assert staged[2][1] > 0 and staged[1].get("demand", 0) > 0   # spills
    layers = staged_eng.cfg.num_layers
    assert staged[3]["paged_attention_decode"] == \
        staged_eng.paged_rounds * layers
    st = staged_eng.staged.stats()
    assert sum(st["rounds"].values()) == staged_eng.paged_rounds
    assert len(st["rounds"]) > 1                     # several batch sizes
    assert st["captures"] == st["replays"] == 0      # no graph on the CPU
    assert st["eager_rounds"] == staged_eng.paged_rounds
    assert st["pool_pages"] >= ECFG["onboard_pages"]


def test_pages_are_gathered_into_the_pool_buffer(jax_params):
    """``decode_view`` gathers each round's pages straight into the pool
    buffer's rows (no second copy), and the buffer starts at the onboard
    tier's page count and doubles only as far as the largest round's
    union needs."""
    eng = _port_engine("qwen2-1.5b", jax_params)
    view_fn, seen = eng.kv.decode_view, []

    def view(*args, **kw):
        v = view_fn(*args, **kw)
        assert v.pool.data_ptr() == eng.staged.pool.data_ptr()
        seen.append(len(v.pool))
        return v

    eng.kv.decode_view = view
    _serve(eng, SubmitSpec)
    assert len(seen) == eng.paged_rounds
    size, doublings = ECFG["onboard_pages"], 0
    while size < max(seen):
        size, doublings = 2 * size, doublings + 1
    st = eng.staged.stats()
    assert max(seen) > ECFG["onboard_pages"]          # it grew
    assert st["pool_pages"] == size
    assert 2 <= st["regrowths"] <= doublings + 1      # made, then grown


@pytest.mark.parametrize("pages", [[3], [3, 3], [0, 1, 2], [2, 0, 2],
                                   [0, 5, 0, 7, 1, 6]])
def test_read_many_into_out_is_read_many(pages):
    """``LinkedBuffer.read_many(out=)`` gathers into ``out`` what it
    returns without: the same pages, link bytes, hits and misses, on the
    one-page path, a single wave and waves past the onboard tier (3
    pages)."""
    from repro_torch.core.metrics import Metrics
    from repro_torch.core.offload import TierExecutor
    runs = []
    for into in (False, True):
        metrics = Metrics()
        system = system_for("d0", host_id="h0", pool_gib=1,
                            page_bytes=1 << 16, metrics=metrics)
        buf = system.buffer(name="kv", device_id="d0", page_shape=(4, 8),
                            onboard_pages=3, dtype=torch.float32,
                            executor=TierExecutor("cpu"), metrics=metrics)
        buf.append_pages(8)
        for p in range(8):
            buf.write(p, torch.full((4, 8), float(p)))
        out = torch.full((len(pages), 4, 8), float("nan")) if into else None
        got = buf.read_many(pages, out=out)
        if into:
            assert got.data_ptr() == out.data_ptr()
        tier = metrics.tier("kv", "onboard")
        runs.append((got.clone(), buf.host.fm.op_bytes(),
                     (tier.hits, tier.misses)))
    (plain, *rest), (into, *into_rest) = runs
    torch.testing.assert_close(into, plain, rtol=0, atol=0)
    assert [float(r[0, 0]) for r in into] == [float(p) for p in pages]
    assert into_rest == rest


def test_params_swapped_for_other_tensors_raise(jax_params):
    """The graphs read params at the addresses they were captured with:
    params updated in place serve on, a leaf swapped for a new tensor
    raises."""
    eng = _port_engine("qwen2-1.5b", jax_params)
    rng = np.random.default_rng(3)
    eng.submit(SubmitSpec(prompt=rng.integers(1, 100, 9).astype(np.int32),
                          max_new_tokens=6))
    eng.run(3)
    assert eng.paged_rounds > 0
    norm = eng.params["final_norm"]
    with torch.no_grad():
        norm["scale"].mul_(1.0)
    eng.run(1)
    norm["scale"] = norm["scale"].clone()
    with pytest.raises(ValueError, match="in place"):
        eng.run(1)


def test_page_table_never_maps_a_pool_row_at_or_past_n(jax_params,
                                                        monkeypatch):
    """Each round's page table maps only rows ``0..n-1`` of the pool
    buffer, and the rows past ``n`` are never read: they hold NaN here,
    and the streams are the eager engine's."""
    stage = StagedStep._stage
    seen = []

    def poisoned(self, pool, page_table, lengths, token):
        B = stage(self, pool, page_table, lengths, token)
        n = pool.shape[0]
        table = self.page_table[:B]
        assert int(table.max()) < n and bool((table >= -1).all())
        self.pool[n:] = float("nan")
        seen.append((B, n))
        return B

    eager = _serve(_port_engine("qwen2-1.5b", jax_params, staged=False),
                   SubmitSpec)
    monkeypatch.setattr(StagedStep, "_stage", poisoned)
    eng = _port_engine("qwen2-1.5b", jax_params)
    staged = _serve(eng, SubmitSpec)
    assert staged == eager
    assert len(seen) == eng.paged_rounds
    assert any(n < eng.staged.pool.shape[0] for _, n in seen)


def test_steps_run_at_the_exact_batch_size(modelling_reference, jax_params):
    """dbrx-132b's expert capacity follows the token count: the staged
    step runs every round at the live batch's own B (one graph each on
    the card), never padded, and its streams, and so its drops, are the
    reference's.  Padding a batch of 3 to 4 rows changes the real rows'
    logits: capacity ceil(K * B * 1.25 / E) grows from 2 to 3."""
    arch = "dbrx-132b"
    eng = _port_engine(arch, jax_params)
    rows, step = [], eng.staged.step

    def record(params, pool, page_table, lengths, token):
        rows.append((token.shape[0], len(eng.active)))
        return step(params, pool, page_table, lengths, token)

    eng.staged.step = record
    got = _serve(eng, SubmitSpec)
    assert got[:3] == _serve(_reference_engine(arch, jax_params),
                             JSubmitSpec)[:3]
    assert all(b == live for b, live in rows)
    assert sorted(eng.staged.rounds) == sorted({b for b, _ in rows})

    cfg = eng.cfg
    model = eng.model
    gen = torch.Generator().manual_seed(0)
    T, MP, P = 8, 4, 12
    pool = torch.randn((P, cfg.num_layers, 2, T, cfg.num_kv_heads,
                        cfg.head_dim_), generator=gen)
    table = torch.arange(P, dtype=torch.int32).reshape(3, MP)
    lengths = torch.tensor([9, 20, 30], dtype=torch.int32)
    token = torch.tensor([[3], [5], [7]], dtype=torch.int32)
    exact, _ = model.decode_step_paged(eng.params, pool.clone(), table,
                                       lengths, token)
    padded, _ = model.decode_step_paged(
        eng.params, torch.cat([pool, pool[:1]]),
        torch.cat([table, torch.tensor([[P, -1, -1, -1]],
                                       dtype=torch.int32)]),
        torch.cat([lengths, torch.tensor([0], dtype=torch.int32)]),
        torch.cat([token, token[:1]]))
    assert not torch.allclose(exact, padded[:3])


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the CUDA "
                    "kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_graphs_match_eager_on_the_card(cuda_device, jax_params,
                                                 arch):
    """Staged against eager on the card: the same streams, link bytes,
    hits and misses, and the paged kernel launched layers x rounds in
    both, counted through replays."""
    runs = []
    for staged in (False, True):
        eng = _port_engine(arch, jax_params, device=cuda_device,
                           staged=staged)
        cuda_build.reset_launch_counts()
        got = _serve(eng, SubmitSpec)
        runs.append((got, cuda_build.launch_counts(), eng))
    (eager, eager_launch, _), (staged, staged_launch, eng) = runs
    assert staged == eager
    assert staged_launch == eager_launch
    assert staged_launch["paged_attention"] == \
        eng.paged_rounds * eng.cfg.num_layers
    st = eng.staged.stats()
    recurring = sum(1 for n in st["rounds"].values() if n > 1)
    assert st["eager_rounds"] == len(st["rounds"]) > 1   # each B's first
    assert st["captures"] >= recurring > 0
    assert st["replays"] == eng.paged_rounds - st["eager_rounds"] > 0


@pytest.mark.cuda
def test_a_host_sync_in_the_step_raises(cuda_device, jax_params):
    """Capture refuses a host sync inside the step: the first round at
    B = 1 runs eagerly, the second captures, and the engine raises there
    and does not carry on eagerly."""
    eng = _port_engine("qwen2-1.5b", jax_params, device=cuda_device)
    step = eng.staged.step

    def syncing(params, pool, page_table, lengths, token):
        int(lengths.max())                  # a host sync
        return step(params, pool, page_table, lengths, token)

    eng.staged.step = syncing
    eng.submit(SubmitSpec(prompt=np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=4))
    with pytest.raises(RuntimeError):
        eng.run(10)
    assert eng.staged.captures == 0
    assert eng.paged_rounds == eng.staged.eager_rounds == 1
