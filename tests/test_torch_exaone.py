"""k-exaone-236b-a23b on the port's serving path, held to the benchmark's
plain reference (``bench/reference/k_exaone.py``) at the CPU size of
``bench/tests/small.py`` with one dense layer and one LLLG period (5
layers), in float32: prefill and then paged decode through the pool
against the reference's full forward pass, on logits; the expert layer's
shares over all chips against the uncut layer; the engine's paged path
and its spans and counters."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import deploy, weights
from bench.reference.k_exaone import Reference
from bench.tests import small
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import pages_read
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import layer_attention
from repro_torch.models.flags import Flags
from torch_threads import one_thread  # noqa: F401  (a fixture)

NAME = "k-exaone-236b-a23b"
#: f32 on both sides: the program and the reference sum in other orders
#: (paged softmax partials, grouped expert sums), so logits agree to
#: rounding, ~1e-6 of logits of order 1-10
TOL = 2e-5


def _config(layers=5):
    cfg = small.config(NAME)
    cfg["model"]["num_layers"] = layers
    return cfg


def _model(cfg, seed=11):
    model = build_model(deploy.arch_config(cfg), Flags(remat=False),
                        device="cpu")
    return model, weights.make(model.abstract_params(), seed, "cpu",
                               cfg["init_std"])


def test_registered_config_is_the_published_model():
    c = get_config(NAME)
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.head_dim, c.vocab_size) == (48, 6144, 64, 8, 128, 153600)
    assert (c.d_ff, c.dense_d_ff, c.dense_layers) == (2048, 18432, 1)
    assert (c.num_experts, c.top_k, c.experts_held, c.shared_experts,
            c.routed_scale, c.router_score) == (128, 8, 128, 1, 2.5,
                                                "sigmoid")
    assert (c.sliding_window, c.window_pattern, c.global_rope,
            c.post_norm, c.tie_embeddings) == (128, "LLLG", False, True,
                                               False)
    kinds = [layer_attention(c, l) for l in range(48)]
    assert kinds.count((128, True)) == 36 and kinds.count((None, False)) \
        == 12
    r = c.reduced()
    assert r.num_layers >= 5 and 0 < r.experts_held < r.num_experts
    assert r.sliding_window < 48           # below the tests' prompts
    assert build_model(c, device="cpu").supports_paged_decode()


def _pages(cache, length, room, T):
    """A prefill cache's first ``length`` tokens as pool pages [n, L, 2, T,
    KV, hd], with pages for ``room`` more tokens (zero past ``length``)."""
    L, _, _, KV, hd = cache["k"].shape
    out = torch.zeros((-(-(length + room) // T), L, 2, T, KV, hd))
    for t in range(length):
        out[t // T, :, 0, t % T] = cache["k"][:, 0, t]
        out[t // T, :, 1, t % T] = cache["v"][:, 0, t]
    return out


@pytest.mark.parametrize("T", [8, 5])
def test_prefill_then_paged_decode_matches_the_reference(T):
    """Two prompts (21 and 34 tokens, past the reduced window of 16)
    prefilled, their caches laid out on pages of T tokens (windows then
    cross page edges: 8 divides 16, 5 does not), then 12 paged decode steps
    of both rows in one batch, each fed the reference's best token; every
    step's logits against the reference's full forward pass over the
    prompt and the fed tokens.  The selection bias is drawn non-zero and
    changes some tokens' choices, so the routing under test is the
    biased one."""
    cfg = _config()
    m = cfg["model"]
    model, params = _model(cfg)
    ref = Reference(m, params)
    rng = np.random.default_rng(T)
    prompts = [torch.as_tensor(rng.integers(0, m["vocab_size"], n))
               for n in (21, 34)]
    steps = 12
    bias = params["trunk"]["moe"]["select_bias"]
    assert bias.abs().min() > 0
    pools, tables, logits = [], [], []
    for p in prompts:
        lg, cache = model.prefill(params, {"tokens": p[None].to(torch.int32)},
                                  model.init_cache(1, 128))
        logits.append([lg[0]])
        pg = _pages(cache, len(p), steps, T)
        first = sum(x.shape[0] for x in pools)
        pools.append(pg)
        tables.append(list(range(first, first + pg.shape[0])))
    pool = torch.cat(pools)
    MP = max(len(t) for t in tables)
    table = torch.full((2, MP), -1, dtype=torch.int32)
    for b, t in enumerate(tables):
        table[b, :len(t)] = torch.as_tensor(t)
    seqs = [p.clone() for p in prompts]
    for step in range(steps):
        toks = torch.stack([lg[-1].argmax() for lg in logits])
        seqs = [torch.cat([s, t[None]]) for s, t in zip(seqs, toks)]
        lengths = torch.tensor([len(s) - 1 for s in seqs], dtype=torch.int32)
        lg, pool = model.decode_step_paged(params, pool, table, lengths,
                                           toks[:, None].to(torch.int32))
        for b in range(2):
            logits[b].append(lg[b])
    want = ref.logits(seqs, [range(len(p) - 1, len(s))
                             for p, s in zip(prompts, seqs)])
    for got, w in zip(logits, want):
        torch.testing.assert_close(torch.stack(got), w, rtol=TOL, atol=TOL)
    # the bias moves some tokens' expert choice
    x = torch.randn(64, m["d_model"], generator=torch.Generator()
                    .manual_seed(0)) * 3
    lp = {k: v[0] for k, v in params["trunk"]["moe"].items()
          if not isinstance(v, dict)}
    s = torch.sigmoid(x @ lp["router"])
    plain = torch.topk(s, m["top_k"], dim=-1).indices.sort(-1).values
    ids, _ = moe_mod.route_sigmoid(lp, model.cfg, x)
    assert (ids.sort(-1).values != plain).any()


def test_expert_shares_add_up_to_the_uncut_layer():
    """The share test: a layer of 8 experts, cut into the 2 shares of 4
    that 2 chips hold (each told its first id), plus the shared expert
    counted once, adds up to the uncut layer (all 8 held) of the plain
    reference.  Only the routed part is cut: every chip routes over all 8
    with the same router."""
    cfg = _config()
    m = dict(cfg["model"], experts_held=cfg["model"]["num_experts"])
    arch = dataclasses.replace(deploy.arch_config(cfg), experts_held=8)
    model = build_model(arch, Flags(remat=False), device="cpu")
    params = weights.make(model.abstract_params(), 5, "cpu",
                          cfg["init_std"])
    full = {k: v[1] for k, v in params["trunk"]["moe"].items()
            if not isinstance(v, dict)}
    full["shared"] = {k: {"w": v["w"][1]} for k, v in
                      params["trunk"]["moe"]["shared"].items()}
    x = torch.randn(3, 7, m["d_model"],
                    generator=torch.Generator().manual_seed(1)) * 2
    held = 4
    parts = []
    for chip in range(2):
        lo = chip * held
        share = {k: full[k] for k in ("router", "select_bias")}
        share.update({k: full[k][lo:lo + held]
                      for k in ("w_gate", "w_up", "w_down")})
        if chip == 0:
            share["shared"] = full["shared"]
        parts.append(moe_mod.routed_apply(share, arch, x, first=lo))
    ref = Reference(m, params)
    w = {k: ref._w(v) if v.dim() > 1 else v for k, v in full.items()
         if k != "shared"}
    w["shared"] = {k: ref._w(v["w"]) for k, v in full["shared"].items()}
    want = ref._experts(x.reshape(-1, m["d_model"]), w).reshape(x.shape)
    torch.testing.assert_close(parts[0] + parts[1], want, rtol=TOL,
                               atol=TOL)
    # and the program's uncut layer is the same sum
    torch.testing.assert_close(moe_mod.routed_apply(full, arch, x), want,
                               rtol=TOL, atol=TOL)
    # a share alone is not the layer: the other chip's experts matter
    assert not torch.allclose(parts[0], want, rtol=TOL, atol=TOL)


def test_engine_serves_on_the_paged_path_and_traces_it(one_thread):
    """The cell at the CPU size through ``bench.run.execute``: served on
    the paged path, every served token the reference's best (f32), the
    float8 control judged not correct by the same limits.  With the
    program's tracer on, each paged round's ``serve.decode`` carries the
    pages its windowed and its full layers read, as the lengths imply,
    and every eager expert layer's routing is a ``moe.route`` span; the
    dispatcher counts one expert call per MoE layer a step and one paged
    call per layer a round."""
    from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
    from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
    cfg = _config()
    # a longer window than small.run's 2 s: the check wants 20 served
    # tokens of finished requests, and a loaded CPU serves them slower
    res = small.run(f"{NAME}.doc-chat", seed=2**40 + 7, cfg=cfg,
                    seconds=5.0, control=True)
    assert res["correct"], res["check"]
    assert res["control_correct"] is False
    model, params = _model(cfg, seed=3)
    ecfg = dict(cfg["engine"], trace=True)
    system = LMBSystem(SystemSpec(
        expanders=1, pool_gib=1, hosts=(HostSpec("server",
                                                 page_bytes=4096),),
        devices=(DeviceSpec("gpu0"),)))
    eng = ServeEngine(model, params, system, EngineConfig(**ecfg),
                      device="cpu")
    assert eng.stats()["decode_path"] == "paged"
    rng = np.random.default_rng(0)
    for n in (20, 33, 41):
        eng.submit(SubmitSpec(prompt=rng.integers(
            0, cfg["model"]["vocab_size"], n).astype(np.int32),
            max_new_tokens=6))
    seen = []
    view = eng.kv.decode_view

    def recorded(*a, **kw):
        v = view(*a, **kw)
        seen.append([int(n) for n in v.lengths])
        return v
    eng.kv.decode_view = recorded
    before = kops.dispatch_counts()
    eng.run(100)
    after = kops.dispatch_counts()
    spans = eng.trace.spans()
    T, W = cfg["engine"]["page_tokens"], cfg["model"]["sliding_window"]
    L = cfg["model"]["num_layers"]
    decodes = [s for s in spans if s.name == "serve.decode"]
    assert len(decodes) == eng.paged_rounds == len(seen) > 0
    windowed = sum(layer_attention(model.cfg, l)[0] is not None
                   for l in range(L))
    assert 0 < windowed < L
    for d, lengths in zip(decodes, seen):
        n = [x + 1 for x in lengths]
        assert d.args["window_pages"] == windowed * pages_read(n, T, W)
        assert d.args["full_pages"] == (L - windowed) * pages_read(n, T)
    assert any(d.args["window_pages"] < d.args["full_pages"] * windowed
               / (L - windowed) for d in decodes)
    routes = [s for s in spans if s.name == "moe.route"]
    moe_layers = L - cfg["model"]["dense_layers"]
    prefills = sum(1 for s in spans if s.name == "serve.prefill")
    assert len(routes) == moe_layers * (prefills + len(decodes))
    assert after["expert_ffn"] - before["expert_ffn"] == len(routes)
    assert after["paged_attention_decode"] - before[
        "paged_attention_decode"] == L * len(decodes)


def test_counts_and_expert_readers():
    """The architecture file's counts at the published widths: a windowed
    layer's keys stop at the window, the held experts count at the
    expected pairs and reached experts; the two new readers read the
    expert kernels' device time from a record and nothing where the
    architecture or the trace has no expert kernel (granite's)."""
    import json

    from bench import counts, manifest
    from bench.reference import k_exaone, model as dense_ref
    m = json.loads((manifest.ROOT / "bench/configs/k-exaone-236b-a23b.json")
                   .read_text())["model"]
    H, hd = m["num_heads"], m["head_dim"]
    # one token after 1,000 stored: 36 layers attend 128 keys, 12 all 1,001
    d1, d0 = k_exaone.decode_flops(m, 1000), k_exaone.decode_flops(m, 0)
    assert d1 - d0 == pytest.approx(4.0 * H * hd * (36 * 127 + 12 * 1000))
    # past the window only the full layers grow
    assert k_exaone.decode_flops(m, 2000) - d1 == pytest.approx(
        4.0 * H * hd * 12 * 1000)
    # the held experts: 8 of 128 held, top-8 -> half a pair a token
    e1 = k_exaone.expert_least_s(m, 1)
    reached = 8 * (1 - (1 - 8 / 128))
    assert e1 == pytest.approx(47 * counts.least_seconds(
        2.0 * 3 * 6144 * 2048 * 0.5, reached * 3 * 6144 * 2048 * 2
        + 2.0 * 6144 * 2))
    assert k_exaone.expert_least_s(m, 4096) < 48 * counts.least_seconds(
        0, 8 * 3 * 6144 * 2048 * 2 + 2.0 * 4096 * 6144 * 2)
    # windowed paged calls: at most 128 keys a row
    lengths = [1000, 50]
    one = k_exaone.paged_least_s(m, lengths, 128)
    assert one < 48 * counts.least_seconds(*counts.paged_attention_call(
        m, lengths, 128))
    rec = {"model": m, "reference": "bench/reference/k_exaone.py",
           "trace": {"kernels": {"expert_gate_up_kernel": 2e-3,
                                 "expert_down_kernel": 1e-3,
                                 "expert_combine_kernel": 1e-3,
                                 "paged_split_kernel_mma": 1e-3},
                     "rounds": [{"prefills": [1500], "contexts": [[9] * 32]},
                                {"prefills": [], "contexts": [[9] * 32]}]}}
    read = {n: manifest.reader(n) for n in ("expert_roofline", "expert_ms")}
    assert read["expert_ms"](rec) == pytest.approx(2.0)
    least = k_exaone.expert_least_s(m, 1500) + 2 * k_exaone.expert_least_s(
        m, 32)
    assert read["expert_roofline"](rec) == pytest.approx(100 * least / 4e-3)
    # granite's architecture file has no expert count; no kernels, nothing
    g = dict(rec, reference="bench/reference/model.py")
    assert read["expert_roofline"](g) is None
    assert not hasattr(dense_ref, "expert_least_s")
    bare = dict(rec, trace={"kernels": {"paged_split_kernel_mma": 1e-3},
                            "rounds": rec["trace"]["rounds"]})
    assert read["expert_ms"](bare) is None
    assert read["expert_roofline"](bare) is None
    assert read["expert_ms"](dict(rec, trace=None)) is None


@pytest.mark.cuda
def test_card_counts_equal_the_launches():
    """On the card, the cell at the CPU size in bf16 through the staged
    engine (eager calls, captures and replays): ``cuda_build.LAUNCHES``
    counts one windowed paged call per windowed layer a round and one
    expert call per expert layer a prefill and a round, replays
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.expert_ffn import LAUNCHES as EXPERT
    from repro_torch.kernels.paged_attention import WINDOWED_LAUNCHES
    from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
    cfg = _config()
    cfg["model"]["dtype"] = "bfloat16"
    model = build_model(deploy.arch_config(cfg), Flags(remat=False,
                                                       use_kernels=True),
                        device="cuda")
    params = weights.make(model.abstract_params(), 3, "cuda",
                          cfg["init_std"])
    system = LMBSystem(SystemSpec(
        expanders=1, pool_gib=1, hosts=(HostSpec("server",
                                                 page_bytes=4096),),
        devices=(DeviceSpec("gpu0"),)))
    eng = ServeEngine(model, params, system, EngineConfig(**cfg["engine"]),
                      device="cuda")
    rng = np.random.default_rng(1)
    for n in (20, 33, 41, 20):
        eng.submit(SubmitSpec(prompt=rng.integers(
            0, cfg["model"]["vocab_size"], n).astype(np.int32),
            max_new_tokens=9))
    before = cuda_build.launch_counts()
    eng.run(200)
    after = cuda_build.launch_counts()
    L = cfg["model"]["num_layers"]
    windowed = sum(layer_attention(model.cfg, l)[0] is not None
                   for l in range(L))
    moe_layers = L - cfg["model"]["dense_layers"]
    prefills = sum(eng.staged_prefill.calls.values())
    assert eng.staged.replays > 0 and eng.staged_prefill.replays > 0
    assert after[WINDOWED_LAUNCHES] - before.get(WINDOWED_LAUNCHES, 0) \
        == windowed * eng.paged_rounds
    assert after[EXPERT] - before.get(EXPERT, 0) == moe_layers * (
        prefills + eng.paged_rounds)
    system.close()
