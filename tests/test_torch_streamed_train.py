"""The streamed train step: ``make_train_step_(..., streams=...)``, the
port's counterpart of the reference's in-jit offload mode, which pages a
parked optimizer state leaf by leaf on a device's copy streams beside the
forward and backward passes and the update.

On the CPU the stream calls go to a recording stand-in (``Recorder`` in
``tests/stream_recorder.py``): it keeps a vector clock per stream, as
CUDA orders work (program order on a stream; an event carries everything
its stream had issued; a wait merges it in), so one run of the step
yields the happens-before relation of every copy and every compute
operation, and the tests read the schedule's guarantees off it.  The
recorder pages every leaf (``moves``), into fresh CPU tensors and back,
so the values test runs the copies themselves.  Streamed against the
serial schedule: bit for bit (the same expressions, each leaf
independent, the global norm summed in the same order).  The launcher's
matrix over five reduced configs (streamed against serial and the
reference) is in ``tests/train_launcher_cases.py``, run one config a
file by ``tests/test_torch_train_launcher_*.py``.
"""

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import offload
from repro_torch.data.pipeline import DataConfig, make_dataset
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.models.flags import Flags
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_paths
from repro_torch.train import loop
from repro_torch.train.loop import make_train_step_, opt_state_init
from repro_torch.train.staged import OUTPUTS, StagedTrainStep
from repro_torch.train.trace import busy_split, kind_of
from stream_recorder import Recorder as _Recorder
from stream_recorder import before as _before

ARCH = "qwen2-1.5b"
LR, SEQ = 1e-3, 32


def _instrument(monkeypatch, rec):
    """Log the step's compute operations on ``rec``: the forward and
    backward passes, each compression, the scalars (``count`` advanced),
    the global norm and each leaf's update."""
    wrap = lambda name, fn, kind, who=lambda *a: {}: monkeypatch.setattr(
        loop, name, lambda *a, **k: (rec.op(kind, **who(*a)),
                                     fn(*a, **k))[1])
    wrap("_loss_and_grads", loop._loss_and_grads, "fwd_bwd")
    wrap("ef_compress_", loop.ef_compress_, "compress",
         lambda g, err: {"t": err})
    wrap("adamw_scalars_", loop.adamw_scalars_, "scalars",
         lambda cfg, grads, count: {"t": count})
    wrap("adamw_leaf_", loop.adamw_leaf_, "update",
         lambda cfg, sc, g, m, v, master, p: {"t": m, "v": v,
                                              "master": master})
    norm = adamw.global_norm
    monkeypatch.setattr(adamw, "global_norm",
                        lambda tree: (rec.op("norm"), norm(tree))[1])


def _tiny_step(compress, accum=2, device="cpu"):
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, Flags(remat=False, attn_chunk=16),
                        device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    state = opt_state_init(params, compress)
    data = make_dataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}
    return model, params, state, batch


def _outs(device="cpu"):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in OUTPUTS}


# ------------------------------------------------------------ schedule
@pytest.mark.parametrize("compress", [True, False])
def test_streamed_schedule_happens_before(monkeypatch, compress):
    """One streamed step, recorded: each leaf paged in once on the H2D
    stream and out once on the D2H stream; every page-in issued before
    the forward pass and not ordered after it; compression of leaf i
    after its ``ef_err`` landed, the global norm after every
    compression, the scalars after ``count`` landed, the update of leaf
    i after its ``m``, ``v`` and ``master`` landed; no page-out of a leaf
    before its last write, ``count`` out last; both copy streams joined
    to the compute stream before the step returns."""
    model, params, state, batch = _tiny_step(compress)
    rec = _Recorder()
    _instrument(monkeypatch, rec)
    where = {id(t): path for path, t in offload._paths(state)}
    step_ = make_train_step_(model, adamw.AdamWConfig(lr=LR), 2, compress,
                             streams=rec)
    step_(params, state, batch, _outs())
    log = rec.log
    ins = {where[id(o["src"])]: o for o in log
           if o["kind"] == "copy" and o["stream"] == "h2d"}
    outs = {where[id(o["dst"])]: o for o in log
            if o["kind"] == "copy" and o["stream"] == "d2h"}
    live = {id(o["dst"]): p for p, o in ins.items()}
    assert len(ins) == len(outs) == len(where)
    assert set(ins) == set(outs) == set(where.values())
    fwd, = [o for o in log if o["kind"] == "fwd_bwd"]
    for o in ins.values():
        assert log.index(o) < log.index(fwd) and not _before(fwd, o)

    paths = tree_paths(params)
    comp = {live[id(o["t"])][1:]: o for o in log if o["kind"] == "compress"}
    upd = {live[id(o["t"])][1:]: o for o in log if o["kind"] == "update"}
    norm, = [o for o in log if o["kind"] == "norm"]
    scalars, = [o for o in log if o["kind"] == "scalars"]
    assert sorted(upd) == sorted(paths)
    assert sorted(comp) == (sorted(paths) if compress else [])
    for p, o in comp.items():
        assert _before(ins[("ef_err",) + p], o)
        assert _before(o, norm)
        assert _before(o, outs[("ef_err",) + p])
    assert _before(ins[("count",)], scalars)
    assert _before(scalars, outs[("count",)])
    for p, o in upd.items():
        assert _before(scalars, o)
        for k in ("m", "v", "master"):
            assert _before(ins[(k,) + p], o)
            assert _before(o, outs[(k,) + p])
    last = max(outs.values(), key=lambda o: o["clock"]["d2h"])
    assert last is outs[("count",)]
    end = rec.clock["compute"]
    for o in list(ins.values()) + list(outs.values()):
        assert o["clock"][o["stream"]] <= end[o["stream"]]


def test_the_recorder_sees_a_missing_wait(monkeypatch):
    """The relation above is not vacuous: with compression's wait on its
    ``ef_err`` page-in dropped, the recorder finds compression not
    ordered after the copy."""
    model, params, state, batch = _tiny_step(True)
    rec = _Recorder()
    _instrument(monkeypatch, rec)
    real_wait = rec.wait
    ef = {id(t) for t in tree_leaves(state["ef_err"])}
    arrived = []
    page_in = loop.page_in_streamed

    def spy(parked, order, streams):
        live, ev = page_in(parked, order, streams)
        arrived.extend(id(ev[p]) for p in order if p[0] == "ef_err")
        return live, ev
    monkeypatch.setattr(loop, "page_in_streamed", spy)
    monkeypatch.setattr(rec, "wait", lambda s, e: None if id(e) in arrived
                        else real_wait(s, e))
    step_ = make_train_step_(model, adamw.AdamWConfig(lr=LR), 2, True,
                             streams=rec)
    step_(params, state, batch, _outs())
    ins = [o for o in rec.log if o["kind"] == "copy"
           and o["stream"] == "h2d" and id(o["src"]) in ef]
    comp = [o for o in rec.log if o["kind"] == "compress"]
    assert ins and comp
    assert not any(_before(i, c) for i, c in zip(ins, comp))


def test_page_in_streamed_refuses_an_order_that_misses_a_leaf():
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    with pytest.raises(ValueError, match="page-in order"):
        offload.page_in_streamed(tree, [("a",)], _Recorder())
    live, arrived = offload.page_in_streamed(
        tree, [("b", "c"), ("a",)], _Recorder())
    assert set(arrived) == {("a",), ("b", "c")}
    assert torch.equal(live["a"], tree["a"]) and live["a"] is not tree["a"]


# ------------------------------------------------------------ values
@pytest.mark.parametrize("compress", [True, False])
def test_streamed_step_equals_serial_bitwise(compress):
    """Three static steps streamed (every leaf copied out and back by the
    recorder) against the serial schedule from the same params and
    state: outputs, params and state bit for bit, and every tensor keeps
    its storage."""
    model, params, state, batch = _tiny_step(compress)
    p2, s2 = tree_map(torch.clone, params), tree_map(torch.clone, state)
    ptrs = [l.data_ptr() for l in tree_leaves(params) + tree_leaves(state)]
    cfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    streamed = make_train_step_(model, cfg, 2, compress, streams=_Recorder())
    serial = make_train_step_(model, cfg, 2, compress)
    for _ in range(3):
        a = streamed(params, state, batch, _outs())
        b = serial(p2, s2, batch, _outs())
        for k in OUTPUTS:
            assert torch.equal(a[k], b[k])
    for x, y in zip(tree_leaves(params) + tree_leaves(state),
                    tree_leaves(p2) + tree_leaves(s2)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert [l.data_ptr() for l in tree_leaves(params)
            + tree_leaves(state)] == ptrs
    assert int(state["count"]) == 3


def test_launcher_picks_the_schedule():
    """On the CPU the static step is serial unless asked (nothing is
    parked off the device); the eager step cannot stream, and only a
    staged step on a card is traced."""
    kw = dict(steps=1, global_batch=4, seq_len=16, verbose=False,
              device="cpu", offload_opt=True)
    assert offload.supports_in_jit_offload("cpu") is False
    assert train.run(ARCH, **kw)["streamed"] is False
    assert train.run(ARCH, streamed=True, **kw)["streamed"] is True
    with pytest.raises(ValueError, match="only the staged step"):
        train.run(ARCH, staged=False, streamed=True, **kw)
    with pytest.raises(ValueError, match="trace_step"):
        train.run(ARCH, trace_step=0, **kw)


def test_copy_streams_on_the_cpu_are_host_streams():
    s = offload.copy_streams("cpu")
    assert isinstance(s, offload.HostStreams)
    a, b = torch.ones(3), torch.zeros(3)
    with s.on(s.h2d):
        s.copy_(b, a)
    s.wait(s.current(), s.record(s.h2d))
    assert torch.equal(a, b)
    assert not s.moves(a)


# ------------------------------------------------------------ trace
def test_busy_split_reads_overlap():
    """Busy time is the union of each kind's intervals; ``overlap`` the
    time copies ran beside compute, ``both_ways`` H2D beside D2H."""
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.0, 1000.0),
           ("Memcpy HtoD (Pinned -> Device)", 500.0, 1000.0),
           ("ampere_sgemm", 200.0, 300.0),
           ("elementwise_kernel", 400.0, 800.0),
           ("Memcpy DtoH (Device -> Pinned)", 1000.0, 2000.0),
           ("Memcpy DtoD (Device -> Device)", 3500.0, 100.0)]
    got = busy_split(ops)
    assert got == pytest.approx({"h2d": 1.5, "d2h": 2.0, "compute": 1.1,
                                 "overlap": 1.0, "both_ways": 0.5,
                                 "span": 3.6, "ops": 6})
    assert busy_split([])["overlap"] == 0.0
    assert [kind_of(n) for n, _, _ in ops] == [
        "h2d", "h2d", "compute", "compute", "d2h", "compute"]


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_streamed_capture_matches_serial_on_the_card(cuda_device):
    """On the card: the streamed step captured and replayed (state parked
    in pinned host memory, copies on the copy streams inside the graph)
    gives the serial schedule's losses, params and state bit for bit."""
    kw = dict(steps=5, global_batch=4, seq_len=SEQ, verbose=False,
              compress_grads=True, grad_accum=2, offload_opt=True,
              device=cuda_device)
    streamed = train.run(ARCH, **kw)
    serial = train.run(ARCH, streamed=False, **kw)
    assert streamed["streamed"] and not serial["streamed"]
    assert [r["mode"] for r in streamed["step_log"]] == \
        ["eager", "capture", "replay", "replay", "replay"]
    assert streamed["losses"] == serial["losses"]
    for a, b in ((streamed["params"], serial["params"]),
                 (streamed["opt_state"], serial["opt_state"])):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    n = streamed["state_bytes"]
    for rec in streamed["step_log"]:
        assert rec["parked_tiers"] == [offload.PINNED_HOST]
        assert rec["moved"] == {"to_device": n, "to_host": n}


@pytest.mark.cuda
def test_staged_functions_of_a_device_share_one_side_stream(cuda_device):
    """Two engines on one card, and a staged train step, capture on the
    device's one side stream; the copy streams are the device's too."""
    from repro_torch.core import system_for
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.staged import side_stream

    staged = []
    for arch in ("qwen2-1.5b", "rwkv6-7b"):
        model = build_model(get_config(arch).reduced(), Flags(remat=False),
                            device=cuda_device)
        params = model.init(torch.Generator(cuda_device).manual_seed(0))
        for _ in range(2):
            eng = ServeEngine(model, params, system_for(
                "dev0", host_id="h0", pool_gib=1, page_bytes=4096),
                EngineConfig(decode_slots=2, max_seq_len=64, page_tokens=8,
                             onboard_pages=4), device_id="dev0",
                device=cuda_device)
            staged += [eng.staged, eng.staged_prefill]
    model, params, state, batch = _tiny_step(True, device=cuda_device)
    staged.append(StagedTrainStep(make_train_step_(
        model, adamw.AdamWConfig(), 2, True), batch, device=cuda_device))
    assert all(s._stream is side_stream(cuda_device) for s in staged)
    assert offload.copy_streams(cuda_device) is offload.copy_streams(
        "cuda:0")
