"""The yardstick's operation and byte counts against shapes worked by
hand."""

import pytest

from bench import counts

# D=4, F=8, H=2 heads of 2, one KV head, one layer, vocab 256 (padded 256)
M = {"num_layers": 1, "d_model": 4, "d_ff": 8, "num_heads": 2,
     "num_kv_heads": 1, "head_dim": 2, "vocab_size": 256, "act": "swiglu",
     "dtype": "bfloat16"}


def test_matmul_params():
    # q 4x4, k and v 4x2 each, o 4x4, and 3 MLP matrices of 4x8
    assert counts.layer_matmul_params(M) == 16 + 8 + 8 + 16 + 96
    assert counts.layer_matmul_params(dict(M, act="gelu")) == 48 + 64
    assert counts.readout_params(M) == 256 * 4
    assert counts.padded_vocab(dict(M, vocab_size=257)) == 512


def test_prefill_and_decode_flops():
    # S=3: 2*144*3 matmul, causal attention 4*2*2*(1+2+3), readout 2*1024
    assert counts.prefill_flops(M, 3) == 864 + 96 + 2048
    # 5 stored tokens: the new one attends 6
    assert counts.decode_flops(M, 5) == 288 + 4 * 2 * 2 * 6 + 2048


def test_paged_and_flash_calls():
    flops, nbytes = counts.paged_attention_call(M, [2, 5], max_pages=4)
    assert flops == 4 * 2 * 2 * (3 + 6)
    # k and v of 9 live tokens, q and out of 2 rows, table, lengths
    assert nbytes == 2 * 9 * 1 * 2 * 2 + 2 * 2 * 2 * 2 * 2 + 4 * 2 * 4 + 8
    flops, nbytes = counts.flash_attention_call(M, 3)
    assert flops == 4 * 2 * 2 * 6
    assert nbytes == (2 * 3 * 2 * 2 + 2 * 3 * 1 * 2) * 2


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(counts.PEAK_BF16_FLOPS, 0) == 1.0
    assert counts.least_seconds(0, counts.PEAK_HBM_BYTES_PER_S * 2) == 2.0
    assert counts.least_seconds(1.0, 1.0) == pytest.approx(
        1 / counts.PEAK_HBM_BYTES_PER_S)
