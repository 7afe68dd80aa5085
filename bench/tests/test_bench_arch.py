"""Each configuration brings its architecture file: the file is required
and exports the contract's names, the configuration's ``model`` section
reaches the program whole (an unknown key fails), and the count-based
readers, routed through the file, read granite's fixed record exactly as
the expressions they replaced (written out here over ``bench.counts``)."""

import json

import pytest

from bench import counts, deploy, manifest

MAN = manifest.load()
CONTRACT = ("Reference", "prefill_flops", "decode_flops", "paged_least_s",
            "flash_least_s")


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_every_configuration_names_an_architecture_file(name):
    cfg = manifest.config(MAN, name)
    assert cfg["reference"].startswith("bench/reference/")
    arch = manifest.architecture(cfg["reference"])
    for export in CONTRACT:
        assert callable(getattr(arch, export)), export
    # loaded once, by path
    assert manifest.architecture(manifest.ROOT / cfg["reference"]) is arch


def test_a_configuration_without_an_architecture_file_fails_naming_it(
        tmp_path):
    cfg = manifest.config(MAN, "granite-34b")
    del cfg["reference"]
    (tmp_path / "bench/configs").mkdir(parents=True)
    (tmp_path / "bench/configs/bare.json").write_text(json.dumps(cfg))
    man = {"configs": [{"name": "bare", "file": "bench/configs/bare.json"}]}
    with pytest.raises(KeyError, match="bench/configs/bare.json"):
        manifest.config(man, "bare", tmp_path)


def test_arch_config_refuses_a_key_that_is_no_field():
    cfg = manifest.config(MAN, "granite-34b")
    cfg["model"]["num_expert"] = 8
    with pytest.raises(KeyError, match="num_expert"):
        deploy.arch_config(cfg)


def test_arch_config_takes_every_model_key():
    from repro_torch.configs.base import get_config
    cfg = manifest.config(MAN, "granite-34b")
    cfg["model"].update(num_experts=4, top_k=2, capacity_factor=2.0)
    got = deploy.arch_config(cfg)
    assert (got.num_experts, got.top_k, got.capacity_factor) == (4, 2, 2.0)
    assert get_config("granite-34b").num_experts == 0


# --------------------------------------------------- the fixed record
GRANITE = manifest.config(MAN, "granite-34b")
KERNELS = {"void paged_split_kernel_mma<128, 4>(...)": 0.0116,
           "void paged_combine_kernel<128>(...)": 0.0031,
           "void (anonymous namespace)::flash_attention_bf16_kernel<128>"
           "(...)": 0.0897,
           "nvjet_tst_256x136_64x4_2x1_v_bz_coopA_NNT": 0.1915}


def _round(phase, prefills, contexts):
    return {"phase": phase, "wall": 0.21, "layers": {"model_step": 0.04},
            "prefills": prefills, "contexts": contexts}


ROUNDS = [
    _round("window", [512, 1536], [[600, 1000, 33], [601, 1001, 34]]),
    _round("window", [], [[700 + i for i in range(32)]]),
    _round("window", [1023], [[5, 8191 - 65]]),
    _round("after", [777], [[900 + 3 * i for i in range(32)]]),
    _round("after", [], [[1200] * 32, [1201] * 31]),
]
RECORD = {"model": GRANITE["model"], "engine": GRANITE["engine"],
          "reference": GRANITE["reference"], "window_s": 51.0371,
          "tokens": 8123, "rounds": ROUNDS,
          "trace": {"busy_s": 1.427, "window_s": 2.884, "kernels": KERNELS,
                    "rounds": ROUNDS[3:]}}


def _parents_serve_mfu(rec):
    m = rec["model"]
    flops = 0.0
    for r in [r for r in rec["rounds"] if r["phase"] == "window"]:
        flops += sum(counts.prefill_flops(m, S) for S in r["prefills"])
        flops += sum(counts.decode_flops(m, n)
                     for ctx in r["contexts"] for n in ctx)
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)


def _parents_paged(rec):
    tr = rec["trace"]
    secs = sum(s for k, s in tr["kernels"].items()
               if "paged_split_kernel" in k or "paged_combine_kernel" in k)
    m, L = rec["model"], rec["model"]["num_layers"]
    mp = -(-rec["engine"]["max_seq_len"] // rec["engine"]["page_tokens"])
    least = sum(L * counts.least_seconds(
        *counts.paged_attention_call(m, ctx, mp))
        for r in tr["rounds"] for ctx in r["contexts"])
    return 100.0 * least / secs


def _parents_flash(rec):
    tr = rec["trace"]
    secs = sum(s for k, s in tr["kernels"].items()
               if "flash_attention_bf16_kernel" in k)
    m, L = rec["model"], rec["model"]["num_layers"]
    least = sum(L * counts.least_seconds(*counts.flash_attention_call(m, S))
                for r in tr["rounds"] for S in r["prefills"])
    return 100.0 * least / secs


@pytest.mark.parametrize("name,parents", [
    ("serve_mfu", _parents_serve_mfu),
    ("paged_attention_roofline", _parents_paged),
    ("flash_attention_roofline", _parents_flash),
])
def test_count_readers_read_granite_as_before(name, parents):
    want = parents(RECORD)
    assert 0 < want < 100
    assert manifest.reader(name)(RECORD) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["paged_attention_roofline",
                                  "flash_attention_roofline"])
def test_count_readers_read_nothing_without_a_trace(name):
    assert manifest.reader(name)(dict(RECORD, trace=None)) is None
