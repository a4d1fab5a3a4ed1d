"""The yardstick's arithmetic against numbers worked by hand."""

import json

import pytest

from perfbench.harness import flops, spec, weights

CONFIGS = spec.PERFBENCH / "configs"


def model(name):
    return spec.model_from_file(
        name, json.loads((CONFIGS / f"{name}.json").read_text()))


def test_mistral_training_token():
    m = model("mistral-7b-pp4")
    # per layer: wq 4096^2 + wk, wv 2 x 4096 x 1024 + wo 4096^2
    # = 41,943,040; SwiGLU 3 x 4096 x 14336 = 176,160,768
    assert flops.linear_params_per_layer(m) == 41_943_040 + 176_160_768
    per_token_linear = 6 * (8 * 218_103_808 + 4096 * 32000)
    # attention: 3 x 4 x 128 x 32 heads x 8 layers x (4097 / 2) pairs
    per_token_attn = 3 * 4 * 128 * 32 * 8 * 4097 / 2
    step = flops.train_step_flops(m, 2, 4096)
    assert step == pytest.approx(8192 * (per_token_linear + per_token_attn),
                                 rel=1e-12)
    assert step / 8192 / 1e9 == pytest.approx(12.06, abs=0.005)


def test_parameter_counts():
    assert weights.param_count(model("mistral-7b-pp4")) == \
        8 * (218_103_808 + 2 * 4096) + 2 * 4096 * 32000 + 4096
    mixtral = model("mixtral-8x7b-pp4")
    per_layer = 41_943_040 + 8 * 176_160_768 + 4096 * 8 + 2 * 4096
    assert weights.param_count(mixtral) == \
        8 * per_layer + 2 * 4096 * 32000 + 4096
    assert weights.param_count(mixtral) / 1e9 == pytest.approx(11.87,
                                                               abs=0.01)


def test_mixtral_counts_top2_only():
    m = model("mixtral-8x7b-pp4")
    assert flops.linear_params_per_layer(m) == \
        41_943_040 + 2 * 176_160_768 + 4096 * 8


def test_visible_pairs():
    assert flops.visible_pairs(4) == 10
    assert flops.visible_pairs(6, window=3) == 1 + 2 + 3 + 3 + 3 + 3
    assert flops.visible_pairs(1, start=99) == 100
    assert flops.visible_pairs(1, window=64, start=99) == 64
    # a window as long as the sequence is inert
    assert flops.visible_pairs(4096, window=4096) == flops.visible_pairs(4096)


def test_serving_counts():
    m = model("mistral-7b-pp4")
    lin = 2 * (8 * 218_103_808 + 4096 * 32000)
    assert flops.decode_flops(m, 999) == lin + 4 * 128 * 32 * 8 * 1000
    assert flops.prefill_flops(m, 10) == 10 * lin + 4 * 128 * 32 * 8 * 55


def test_flash_k1_to_k3_at_the_old_table_shape():
    # B=4, T=2048, H=18, D=128: 151.07M visible pairs; bounds 0.0782,
    # 0.1179 and 0.1564 ms (operations) in the kernel table, whose K2
    # also counted the row term's products (within 1%)
    pairs = 4 * 18 * 2048 * 2049 // 2
    assert pairs == 151_068_672
    for k, per_pair, ms in (("K1", 4, 0.0782), ("K2", 6, 0.1179),
                            ("K3", 8, 0.1564)):
        f, b = flops.flash_call(k, 4, 2048, 18, 128)
        assert f == per_pair * 128 * pairs
        assert f / flops.PEAK_BF16_FLOPS == flops.least_seconds(f, b)
        assert flops.least_seconds(f, b) * 1e3 == pytest.approx(ms,
                                                                rel=0.01)


def test_flash_bytes():
    t = 2 * 4096 * 32 * 128 * 2          # one bf16 [B, T, H, D] tensor
    kv = 2 * 4096 * 8 * 128 * 2          # one narrow K/V tensor
    row = 2 * 32 * 4096 * 4              # one float32 [B, H, T] row term
    assert flops.flash_call("K1", 2, 4096, 32, 128, 8)[1] == \
        2 * t + 2 * kv + row
    assert flops.flash_call("K2", 2, 4096, 32, 128, 8)[1] == \
        4 * t + 2 * kv + 2 * row
    assert flops.flash_call("K3", 2, 4096, 32, 128, 8)[1] == \
        2 * t + 4 * kv + 2 * row
