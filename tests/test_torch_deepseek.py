"""deepseek-v3 on the port's serving path, held to the benchmark's plain
reference (``bench/reference/deepseek_v3.py``) at the CPU size of
``bench/tests/small.py`` with one dense layer and four routed ones (5
layers), in float32: prefill and then paged decode through the pool
against the reference's full forward pass, on logits; the absorbed decode
against the expanded form; group-limited routing; the expert layer's
shares over all chips against the uncut layer; the reference against
``transformers``' DeepSeek-V3; the engine's paged path and its spans and
counters.  The ``cuda`` tests hold the latent decode kernel and flash's
split-width instantiation to their plain versions on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import deploy, weights
from bench.reference.deepseek_v3 import Reference
from bench.tests import small
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.flags import Flags
from repro_torch.models.pages import PageLayout, page_layout
from repro_torch.models.transformer import mixed_layer
from torch_threads import one_thread  # noqa: F401  (a fixture)

NAME = "deepseek-v3"
#: f32 on both sides: the program and the reference sum in other orders
#: (the absorbed decode's products, paged softmax, grouped expert sums), so
#: logits agree to rounding, ~1e-6 of logits of order 1-10
TOL = 2e-5


def _config(layers=5):
    cfg = small.config(NAME)
    cfg["model"]["num_layers"] = layers
    return cfg


def _model(cfg, seed=11, use_kernels=False):
    model = build_model(deploy.arch_config(cfg),
                        Flags(remat=False, use_kernels=use_kernels),
                        device="cpu")
    return model, weights.make(model.abstract_params(), seed, "cpu",
                               cfg["init_std"])


def test_registered_config_is_the_published_model():
    c = get_config(NAME)
    assert (c.num_layers, c.d_model, c.num_heads, c.vocab_size,
            c.norm_eps) == (61, 7168, 128, 129280, 1e-6)
    assert (c.attention, c.q_lora_rank, c.kv_lora_rank, c.qk_nope_head_dim,
            c.qk_rope_head_dim, c.v_head_dim) == ("mla", 1536, 512, 128, 64,
                                                  128)
    assert (c.yarn_factor, c.yarn_original_max_position, c.yarn_beta_fast,
            c.yarn_beta_slow, c.yarn_mscale, c.yarn_mscale_all_dim,
            c.rope_theta) == (40, 4096, 32, 1, 1, 1, 1e4)
    assert (c.d_ff, c.dense_d_ff, c.dense_layers) == (2048, 18432, 3)
    assert (c.num_experts, c.top_k, c.n_group, c.topk_group, c.experts_held,
            c.shared_experts, c.routed_scale, c.router_score) == (
        256, 8, 8, 4, 256, 1, 2.5, "sigmoid")
    assert c.mixed and not c.post_norm and not c.tie_embeddings
    assert mla_mod.softmax_scale(c) == pytest.approx(
        192 ** -0.5 * (0.1 * np.log(40) + 1) ** 2)
    assert round(mla_mod.softmax_scale(c), 6) == 0.135234
    model = build_model(c, device="cpu")
    assert model.supports_paged_decode()
    assert page_layout(c, 32, 48) == PageLayout((48, 32, 576), 1,
                                                latent=True)
    assert not page_layout(get_config("granite-34b"), 32).latent
    r = c.reduced()
    assert r.dense_layers >= 1 and r.num_layers - r.dense_layers >= 4
    assert 1 < r.topk_group < r.n_group
    assert 0 < r.experts_held < r.num_experts
    assert r.kv_lora_rank != r.num_heads * r.v_head_dim


def _pages(cache, length, room, T):
    """A prefill cache's first ``length`` rows as pool pages [n, L, T, W],
    with pages for ``room`` more tokens (zero past ``length``)."""
    L, _, _, W = cache["latent"].shape
    out = torch.zeros((-(-(length + room) // T), L, T, W))
    for t in range(length):
        out[t // T, :, t % T] = cache["latent"][:, 0, t]
    return out


@pytest.mark.parametrize("T", [8, 5])
def test_prefill_then_paged_decode_matches_the_reference(T):
    """Two prompts (21 and 34 tokens) prefilled, their latent rows laid
    out on pages of T tokens, then 12 paged decode steps of both rows in
    one batch (contexts cross page edges), each fed the reference's best
    token; every step's logits against the reference's full forward pass
    over the prompt and the fed tokens.  The selection bias is drawn
    non-zero and the group limit binds, so the routing under test is the
    biased, group-limited one."""
    cfg = _config()
    m = cfg["model"]
    model, params = _model(cfg)
    ref = Reference(m, params)
    rng = np.random.default_rng(T)
    prompts = [torch.as_tensor(rng.integers(0, m["vocab_size"], n))
               for n in (21, 34)]
    steps = 12
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
    for _ in range(steps):
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


def test_absorbed_decode_equals_the_expanded_form():
    """One layer's attention for the last of 19 tokens: the absorbed form
    (``mla_decode_paged`` over pages of 4 tokens, the plain kernel) against
    the expanded form over the whole sequence (``mla_prefill``), f32."""
    cfg = _config(2)
    model, params = _model(cfg, seed=4)
    c = model.cfg
    lp = mixed_layer(params["trunk"], c, 0)["attn"]
    S, T = 19, 4
    x = torch.randn(1, S, c.d_model, generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(S)[None]
    full, rows = mla_mod.mla_prefill(lp, c, x, mla_mod.rope_tables(c, pos))
    n = -(-S // T)
    pages = torch.zeros((n + 1, T, mla_mod.latent_width(c)))
    pages.view(-1, pages.shape[-1])[:S - 1] = rows[0, :S - 1]
    table = torch.arange(n, dtype=torch.int32)[None]
    lengths = torch.tensor([S - 1], dtype=torch.int32)
    got = mla_mod.mla_decode_paged(
        lp, c, x[:, S - 1:], pages, table, lengths,
        mla_mod.rope_tables(c, lengths[:, None]))
    torch.testing.assert_close(got[:, 0], full[:, S - 1], rtol=TOL, atol=TOL)
    # the step wrote its row where the prefill put it
    torch.testing.assert_close(pages.view(-1, pages.shape[-1])[S - 1],
                               rows[0, S - 1], rtol=TOL, atol=TOL)


def test_group_limited_routing():
    """The top-k over the allowed groups, checked directly: every chosen
    expert lies in one of the ``topk_group`` groups whose two best biased
    scores sum highest, and the choice is the top-k of the biased scores
    restricted to those groups.  With ``n_group`` 1 the ids and gates are
    today's, bit for bit (the top-k of every biased score)."""
    cfg = get_config(NAME).reduced()
    E, G, K = cfg.num_experts, cfg.n_group, cfg.top_k
    gen = torch.Generator().manual_seed(7)
    p = {"router": torch.randn(cfg.d_model, E, generator=gen),
         "select_bias": torch.randn(E, generator=gen) * 0.3}
    x = torch.randn(200, cfg.d_model, generator=gen)
    ids, gates = moe_mod.route_sigmoid(p, cfg, x)
    s = torch.sigmoid(x @ p["router"])
    b = s + p["select_bias"]
    grouped = b.view(-1, G, E // G)
    best = grouped.topk(2, dim=-1).values.sum(-1).topk(cfg.topk_group,
                                                       dim=-1).indices
    limited = 0
    for t in range(len(x)):
        allowed = torch.cat([torch.arange(g * (E // G), (g + 1) * (E // G))
                             for g in best[t].tolist()])
        want = allowed[b[t, allowed].topk(K).indices]
        assert set(ids[t].tolist()) == set(want.tolist())
        limited += set(ids[t].tolist()) != set(b[t].topk(K).indices.tolist())
    assert limited > 0           # the limit binds for some tokens
    w = torch.gather(s, 1, ids)
    torch.testing.assert_close(gates, w / w.sum(-1, keepdim=True)
                               * cfg.routed_scale)
    one = dataclasses.replace(cfg, n_group=1, topk_group=1)
    ids1, gates1 = moe_mod.route_sigmoid(p, one, x)
    plain = torch.topk(s + p["select_bias"], K, dim=-1).indices
    assert torch.equal(ids1, plain)
    w1 = torch.gather(s, 1, plain)
    assert torch.equal(gates1, w1 / (w1.sum(dim=-1, keepdim=True) + 1e-20)
                       * one.routed_scale)


def test_expert_shares_add_up_to_the_uncut_layer():
    """The share test: a routed layer of 8 experts cut into the 2 shares
    of 4 that 2 chips hold (each told its first id), plus the shared
    expert counted once, adds up to the uncut layer (all 8 held) of the
    plain reference, group limit and all: every chip routes over all 8
    with the same router.  The dense layers are whole on every chip and
    take no share."""
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
    torch.testing.assert_close(moe_mod.routed_apply(full, arch, x), want,
                               rtol=TOL, atol=TOL)
    assert not torch.allclose(parts[0], want, rtol=TOL, atol=TOL)


def test_reference_matches_transformers(monkeypatch):
    """The plain reference with every expert held against ``transformers``'
    ``DeepseekV3ForCausalLM`` (eager attention, f32) on the same weights:
    the equations, YaRN and the pair rotation held to a published
    implementation.  ``transformers`` masks the groups left out with 0 where
    the reference takes -inf; the selection bias is drawn positive, so
    every biased score exceeds 0 and the two choose alike."""
    # its PyTorch classes only: importing its TensorFlow and Flax backends
    # would take ~10 s more
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    tr = pytest.importorskip("transformers")
    cfg = _config(3)
    m = dict(cfg["model"], experts_held=cfg["model"]["num_experts"])
    arch = dataclasses.replace(deploy.arch_config(cfg), experts_held=8)
    model = build_model(arch, Flags(remat=False), device="cpu")
    params = weights.make(model.abstract_params(), 9, "cpu",
                          cfg["init_std"])
    bias = params["trunk"]["moe"]["select_bias"]
    bias.abs_()
    V = params["embed"]["table"].shape[0]
    hf = tr.DeepseekV3Config(
        vocab_size=V, hidden_size=m["d_model"],
        intermediate_size=m["dense_d_ff"], moe_intermediate_size=m["d_ff"],
        num_hidden_layers=m["num_layers"], num_attention_heads=m["num_heads"],
        num_key_value_heads=m["num_heads"], n_shared_experts=1,
        n_routed_experts=m["num_experts"], routed_scaling_factor=2.5,
        kv_lora_rank=m["kv_lora_rank"], q_lora_rank=m["q_lora_rank"],
        qk_rope_head_dim=m["qk_rope_head_dim"], v_head_dim=m["v_head_dim"],
        qk_nope_head_dim=m["qk_nope_head_dim"], n_group=m["n_group"],
        topk_group=m["topk_group"], num_experts_per_tok=m["top_k"],
        first_k_dense_replace=m["dense_layers"], norm_topk_prob=True,
        max_position_embeddings=163840, rms_norm_eps=m["norm_eps"],
        rope_theta=m["rope_theta"], tie_word_embeddings=False,
        rope_scaling={"type": "yarn", "factor": 40,
                      "original_max_position_embeddings": 4096,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 1,
                      "mscale_all_dim": 1},
        attn_implementation="eager")
    net = tr.DeepseekV3ForCausalLM(hf).eval()
    t = params["trunk"]

    def put(linear, w):
        linear.weight.data.copy_(w.T)
    net.model.embed_tokens.weight.data.copy_(params["embed"]["table"])
    net.model.norm.weight.data.copy_(params["final_norm"]["scale"])
    put(net.lm_head, params["readout"]["w"])
    for l, layer in enumerate(net.model.layers):
        layer.input_layernorm.weight.data.copy_(t["norm1"]["scale"][l])
        layer.post_attention_layernorm.weight.data.copy_(
            t["norm2"]["scale"][l])
        a, at = layer.self_attn, t["attn"]
        put(a.q_a_proj, at["wq_a"]["w"][l])
        a.q_a_layernorm.weight.data.copy_(at["q_norm"]["scale"][l])
        put(a.q_b_proj, at["wq_b"]["w"][l])
        put(a.kv_a_proj_with_mqa, at["wkv_a"]["w"][l])
        a.kv_a_layernorm.weight.data.copy_(at["kv_norm"]["scale"][l])
        put(a.kv_b_proj, at["wkv_b"]["w"][l])
        put(a.o_proj, at["wo"]["w"][l])
        if l < m["dense_layers"]:
            for k in ("gate", "up", "down"):
                put(getattr(layer.mlp, f"{k}_proj"),
                    t["mlp"][f"w_{k}"]["w"][l])
            continue
        i, mo = l - m["dense_layers"], t["moe"]
        layer.mlp.gate.weight.data.copy_(mo["router"][i].T)
        layer.mlp.gate.e_score_correction_bias.copy_(mo["select_bias"][i])
        for e, ex in enumerate(layer.mlp.experts):
            for k in ("gate", "up", "down"):
                put(getattr(ex, f"{k}_proj"), mo[f"w_{k}"][i][e])
        for k in ("gate", "up", "down"):
            put(getattr(layer.mlp.shared_experts, f"{k}_proj"),
                mo["shared"][f"w_{k}"]["w"][i])
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, m["vocab_size"], 40))
    with torch.no_grad():
        want = net(toks[None]).logits[0]
    got = Reference(m, params).logits([toks], [range(40)])[0]
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_engine_serves_on_the_paged_path_and_traces_it(one_thread):
    """The cell at the CPU size through ``bench.run.execute``: served on
    the paged path, every served token the reference's best (f32), the
    float8 control judged not correct by the same limits.  With the
    program's tracer on, each paged round's ``serve.decode`` carries the
    latent bytes its layers read, as the lengths imply, every eager expert
    layer's routing is a ``moe.route`` span with the group limit; the
    dispatcher counts one latent decode call per layer a round and one
    flash call per layer a prefill."""
    from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
    from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
    cfg = _config()
    res = small.run(f"{NAME}.reasoning", seed=2**40 + 7, cfg=cfg,
                    seconds=5.0, control=True)
    assert res["correct"], res["check"]
    assert res["control_correct"] is False
    model, params = _model(cfg, seed=3, use_kernels=True)
    ecfg = dict(cfg["engine"], trace=True)
    system = LMBSystem(SystemSpec(
        expanders=1, pool_gib=1, hosts=(HostSpec("server",
                                                 page_bytes=4096),),
        devices=(DeviceSpec("gpu0"),)))
    eng = ServeEngine(model, params, system, EngineConfig(**ecfg),
                      device="cpu")
    assert eng.stats()["decode_path"] == "paged"
    assert eng.kv.page_shape == (5, 8, mla_mod.latent_width(model.cfg))
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
    L = cfg["model"]["num_layers"]
    W = mla_mod.latent_width(model.cfg)
    decodes = [s for s in spans if s.name == "serve.decode"]
    assert len(decodes) == eng.paged_rounds == len(seen) > 0
    for d, lengths in zip(decodes, seen):
        assert d.args["latent_bytes"] == L * sum(n + 1 for n in lengths) \
            * W * 4
    routes = [s for s in spans if s.name == "moe.route"]
    assert routes and all((r.args["n_group"], r.args["topk_group"])
                          == (4, 2) for r in routes)
    prefills = sum(1 for s in spans if s.name == "serve.prefill")
    assert len(routes) == (L - 1) * (prefills + len(decodes))
    assert after["mla_decode"] - before["mla_decode"] == L * len(decodes)
    assert after["flash_attention"] - before["flash_attention"] == \
        L * prefills
    assert after["paged_attention_decode"] == before["paged_attention_decode"]
    system.close()


def test_gqa_spans_carry_no_latent_bytes(one_thread):
    """A model with per-head K/V attention (k-exaone-236b-a23b at the CPU
    size) reads no latent rows: its rounds' spans carry no
    ``latent_bytes``, and its routing spans say its groups are 1 and 1."""
    from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
    from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
    cfg = small.config("k-exaone-236b-a23b")
    model, params = _model(cfg)
    system = LMBSystem(SystemSpec(
        expanders=1, pool_gib=1, hosts=(HostSpec("server",
                                                 page_bytes=4096),),
        devices=(DeviceSpec("gpu0"),)))
    eng = ServeEngine(model, params, system,
                      EngineConfig(**dict(cfg["engine"], trace=True)),
                      device="cpu")
    eng.submit(SubmitSpec(prompt=np.arange(12, dtype=np.int32),
                          max_new_tokens=3))
    eng.run(20)
    spans = eng.trace.spans()
    decodes = [s for s in spans if s.name == "serve.decode"]
    assert decodes and all("latent_bytes" not in d.args for d in decodes)
    assert all((r.args["n_group"], r.args["topk_group"]) == (1, 1)
               for r in spans if r.name == "moe.route")
    system.close()


def test_counts_and_mla_readers():
    """The architecture file's counts at the published widths, and the two
    new readers on a record: the kernels' device time by name, the least
    time from ``paged_least_s``, nothing without a trace or the kernels."""
    import json

    from bench import counts, manifest
    from bench.reference import deepseek_v3 as ds
    m = json.loads((manifest.ROOT / "bench/configs/deepseek-v3.json")
                   .read_text())["model"]
    # a cached token: 128 heads x 2 (576 + 512) operations, every layer
    d1, d0 = ds.decode_flops(m, 1000), ds.decode_flops(m, 0)
    assert d1 - d0 == pytest.approx(48 * 1000 * 128 * 2 * (576 + 512))
    # a prompt's attention: 128 heads x 2 (192 + 128) a causal pair
    p = ds.prefill_flops(m, 100) - 2 * ds.prefill_flops(m, 50) \
        + ds.prefill_flops(m, 0)
    assert p == pytest.approx(48 * 128 * 2 * 320 * (5050 - 2 * 1275))
    # one row of 2,499 stored tokens a layer: 2,500 rows of 1,152 bytes
    # read once, q and out, table and length; bound by bytes here
    one = ds.paged_least_s(m, [2499], 168)
    nbytes = 2500 * 1152 + 128 * (576 + 512) * 2 + 4 * 168 + 4
    assert one == pytest.approx(48 * nbytes / counts.PEAK_HBM_BYTES_PER_S)
    rec = {"model": m, "engine": {"max_seq_len": 5376, "page_tokens": 32},
           "reference": "bench/reference/deepseek_v3.py",
           "trace": {"kernels": {
               "(anonymous namespace)::mla_decode_split_kernel(...)": 3e-3,
               "(anonymous namespace)::mla_decode_combine_kernel(...)": 1e-3,
               "expert_gate_up_kernel": 1e-3},
               "rounds": [{"prefills": [1500], "contexts": [[2499] * 64]},
                          {"prefills": [], "contexts": [[2500] * 64]}]}}
    read = {n: manifest.reader(n) for n in ("mla_decode_roofline",
                                             "mla_decode_ms")}
    assert read["mla_decode_ms"](rec) == pytest.approx(2.0)
    least = ds.paged_least_s(m, [2499] * 64, 168) + ds.paged_least_s(
        m, [2500] * 64, 168)
    assert read["mla_decode_roofline"](rec) == pytest.approx(
        100 * least / 4e-3)
    bare = dict(rec, trace={"kernels": {"expert_down_kernel": 1e-3},
                            "rounds": rec["trace"]["rounds"]})
    for r in read.values():
        assert r(bare) is None
        assert r(dict(rec, trace=None)) is None


def test_a_dropped_engine_frees_its_pool():
    """The benchmark drops the engine, then draws the reference's weights
    on the same card: the engine's LMB tier (its onboard pool, 17.7 GiB
    in the cell) must be freed then, though the session that holds its
    fabric lives on.  The fabric holds a buffer's failover and repair
    listeners weakly, so nothing keeps the buffer alive."""
    import gc
    import weakref
    cfg = small.config(NAME)
    engine, system, params, _ = deploy.build(cfg, 3, "cpu")
    buf = weakref.ref(engine.kv.buf)
    pool = weakref.ref(engine.kv.buf._onboard_pool)
    del engine, params
    gc.collect()
    assert buf() is None and pool() is None
    # the listeners left behind do nothing
    system.host().fm.inject_failure(0)
    system.close()


# ------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_card_mla_kernel_matches_plain():
    """The latent decode kernel against its plain version at the cell's
    decode shape (B 64, 128 heads, 576/512 wide, 32-token pages, a table
    of 168), lengths around page and tile edges, rows of length 0 exactly
    zero, pages a strided layer view of a pool; and at 4 heads (rows past
    H in the tile).  bf16: within 2e-2 plus 1.6e-2 of the output's
    magnitude: both sides round their output to bf16, and where the two
    f32 values straddle a rounding point they differ by one unit in the
    last place (2^-7 of the magnitude: 0.03 at outputs of 4, which a
    softmax this peaky gives), 2e-2 the kernels' tolerance at order 1."""
    _card()
    from repro_torch.kernels import mla_decode as md
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, MP, lengths in (
            (64, 128, 168, [0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                            2500, 5376, 4000, 1024, 3072] * 4),
            (3, 4, 6, [1, 0, 191])):
        T, L = 32, 3
        P = B * MP
        pool = torch.randn((P, L, T, 576), generator=gen,
                           device="cuda").to(torch.bfloat16)
        table = torch.randperm(P, generator=gen, device="cuda").to(
            torch.int32).view(B, MP)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((B, H, 576), generator=gen, device="cuda").to(
            torch.bfloat16)
        args = (q, pool[:, 1], table, lens)
        got = md.mla_decode_cuda(*args, scale=0.135, v_width=512)
        want = md.mla_decode_plain(*args, scale=0.135, v_width=512)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                                   atol=2e-2)
        assert not got[lens == 0].any()


@pytest.mark.cuda
def test_card_flash_split_width_matches_plain():
    """flash at q/k 192 and v 128 against its plain version, causal, with
    the latent attention's scale; ragged S; bf16 tolerance as the latent
    decode kernel's (``test_card_mla_kernel_matches_plain``)."""
    _card()
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, S, H in ((1, 300, 16), (2, 77, 8)):
        q, k = (torch.randn((B, S, H, 192), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn((B, S, H, 128), generator=gen, device="cuda").to(
            torch.bfloat16)
        before = cuda_build.launch_counts().get(fa.SPLIT_WIDTH_LAUNCHES, 0)
        got = fa.flash_attention_cuda(q, k, v, scale=0.135)
        want = fa.flash_attention_plain(q, k, v, scale=0.135)
        torch.cuda.synchronize()
        assert got.shape == (B, S, H, 128)
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                                   atol=2e-2)
        assert cuda_build.launch_counts()[fa.SPLIT_WIDTH_LAUNCHES] == \
            before + 1


@pytest.mark.cuda
def test_card_counts_equal_the_launches():
    """On the card, a small model at the kernels' widths (latent 512 + 64,
    q/k 192, v 128) in bf16 through the staged engine (eager calls,
    captures and replays): ``cuda_build.LAUNCHES`` counts one latent
    decode call per layer a round and one split-width flash call per layer
    a prefill, replays included."""
    _card()
    from repro_torch.core import DeviceSpec, HostSpec, LMBSystem, SystemSpec
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    from repro_torch.serve import EngineConfig, ServeEngine, SubmitSpec
    cfg = _config(3)
    arch = dataclasses.replace(
        deploy.arch_config(cfg), dtype="bfloat16", kv_lora_rank=512,
        qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
        head_dim=192)
    model = build_model(arch, Flags(remat=False, use_kernels=True),
                        device="cuda")
    params = weights.make(model.abstract_params(), 3, "cuda", 0.05)
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
    L = arch.num_layers
    prefills = sum(eng.staged_prefill.calls.values())
    assert eng.staged.replays > 0 and eng.staged_prefill.replays > 0
    assert after[md.LAUNCHES] - before.get(md.LAUNCHES, 0) == \
        L * eng.paged_rounds
    assert after[fa.SPLIT_WIDTH_LAUNCHES] - before.get(
        fa.SPLIT_WIDTH_LAUNCHES, 0) == L * prefills
    system.close()
