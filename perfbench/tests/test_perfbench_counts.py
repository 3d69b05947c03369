"""The frozen count functions against shapes worked by hand."""

from __future__ import annotations

import pytest

from perfbench.counts import kernels, mamba2, peaks, transformer

I2 = {"hidden_size": 6144, "intermediate_size": 16384, "num_attention_heads": 48,
      "num_key_value_heads": 8, "head_dim": 128, "num_hidden_layers": 48, "vocab_size": 92544}
M2 = {"d_model": 2560, "n_layer": 64, "vocab_size": 50280, "d_state": 128, "d_conv": 4,
      "expand": 2, "headdim": 64, "chunk_size": 256}


def test_internlm2_flops_per_token():
    # per layer: q 6144x6144, k and v 6144x1024 each, o 6144x6144, three FFN
    # matrices 6144x16384: 2 * (2 * 37748736 + 2 * 6291456 + 3 * 100663296)
    per_layer = 2 * (2 * 6144 * 6144 + 2 * 6144 * 1024 + 3 * 6144 * 16384)
    assert per_layer == 780140544
    assert transformer.flops(I2, tokens=1, keys=0, logit_rows=0) == 48 * per_layer
    # attention: 4 * 48 heads * 128 = 24576 flops a key a layer
    assert transformer.flops(I2, tokens=0, keys=10, logit_rows=0) == 48 * 24576 * 10
    assert transformer.flops(I2, tokens=0, keys=0, logit_rows=1) == 2 * 6144 * 92544


def test_mamba2_flops_per_token():
    # in_proj 2560 -> 2*5120 + 2*128 + 80 = 10576, out_proj 5120 -> 2560,
    # conv 4 taps over 5376 channels, state 80 heads x 64 x 128
    per_layer = 2 * (2560 * 10576 + 5120 * 2560) + 2 * 4 * 5376 + 4 * 80 * 64 * 128
    assert mamba2.flops(M2, tokens=1, keys=99, logit_rows=0) == 64 * per_layer
    assert mamba2.flops(M2, tokens=0, keys=0, logit_rows=2) == 2 * 2 * 2560 * 50280


def test_paged_decode_counts_the_live_rows():
    flops, nbytes = kernels.paged_decode(I2, [100, 300])
    assert flops == 4 * 400 * 48 * 128
    assert nbytes == (2 * 400 * 8 * 128 + 2 * 2 * 48 * 128) * 2
    assert peaks.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_flash_chunk_causal_keys():
    flops, nbytes = kernels.flash_chunk(I2, 4, 10)  # queries at 10..13 see 11..14 keys
    assert flops == 4 * (11 + 12 + 13 + 14) * 48 * 128
    assert nbytes == (2 * 4 * 48 * 128 + 2 * 14 * 8 * 128) * 2
    f256, b256 = kernels.flash_chunk(I2, 256, 1792)
    assert peaks.bound_s(f256, b256) == pytest.approx(f256 / 989e12)  # flops bind


def test_ssd_chunk():
    flops, nbytes = kernels.ssd_chunk(M2, 256)
    pairs = 256 * 257 // 2
    assert flops == 2 * pairs * 128 + 80 * (2 * pairs * 64 + 4 * 256 * 64 * 128)
    state = 80 * 64 * 128 * 4
    assert nbytes == 2 * 256 * 80 * 64 * 2 + 256 * 80 * 4 + 80 * 4 + 2 * 256 * 128 * 2 + 2 * state
    # two blocks, 256 then 44: their pairs and tokens add up
    assert kernels.ssd_chunk(M2, 300)[0] == pytest.approx(
        kernels.ssd_chunk(M2, 256)[0] + kernels.ssd_chunk(M2, 44)[0])
