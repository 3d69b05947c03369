"""The port's KV-page quantization against the reference's
``kernels/quant.py`` and ``attention._quant_paged_write``: equal inputs
give bit-equal int8 / fp8 codes and f32 scales.  The reference functions
run eagerly, op by op, as its own unit tests call them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as RQ
from repro.models import attention as RA
from repro_torch.kernels import quant as PQ
from repro_torch.models import attention as PA

KV = ["int8", "fp8"]


def _rows(seed, shape=(4, 16, 3, 8)):
    """(pages, block_size, n_kv_heads, head_dim): one outlier head, one
    all-zero page."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.array([1.0, 20.0, 0.05], np.float32)[None, None, :, None]
    x[2] = 0.0
    return x


def _codes(t):
    """Codes as comparable numpy bits (fp8 has no numpy type)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


@pytest.mark.parametrize("kv_dtype", KV)
def test_quantize_bit_equal_to_reference(kv_dtype):
    x = _rows(0)
    s_r = RQ.scales_of(jnp.asarray(x), kv_dtype)
    s_p = PQ.scales_of(torch.from_numpy(x), kv_dtype)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
    assert (s_p[2] == 0).all()  # the all-zero page
    c_r = RQ.quantize(jnp.asarray(x), s_r, kv_dtype)
    c_p = PQ.quantize(torch.from_numpy(x), s_p, kv_dtype)
    assert c_p.dtype == PQ.storage_dtype(kv_dtype)
    np.testing.assert_array_equal(_codes(c_p), _codes(c_r))
    assert not _codes(c_p)[2].any()
    np.testing.assert_array_equal(PQ.dequantize(c_p, s_p).numpy(),
                                  np.asarray(RQ.dequantize(c_r, s_r)))


@pytest.mark.parametrize("kv_dtype", KV)
def test_quantize_clips_out_of_range_rows(kv_dtype):
    """Rows beyond the scale's range clip to +-QMAX (an unclipped fp8 cast
    would give NaN), as the reference's do."""
    x = _rows(1) * 3.0
    scale = np.full((4, 3), 0.01, np.float32)
    c_r = RQ.quantize(jnp.asarray(x), jnp.asarray(scale), kv_dtype)
    c_p = PQ.quantize(torch.from_numpy(x), torch.from_numpy(scale), kv_dtype)
    np.testing.assert_array_equal(_codes(c_p), _codes(c_r))
    assert torch.isfinite(c_p.float()).all()


def test_dtype_helpers_and_page_bytes_match_reference():
    assert PQ.KV_DTYPES == RQ.KV_DTYPES
    for kd in PQ.KV_DTYPES:
        assert PQ.is_quantized(kd) == RQ.is_quantized(kd)
        for bs, hkv, hd, item in ((16, 8, 128, 2), (8, 2, 16, 4)):
            assert PQ.page_bytes_est(bs, hkv, hd, kd, compute_itemsize=item) == \
                RQ.page_bytes_est(bs, hkv, hd, kd, compute_itemsize=item)
    for kd in KV:
        assert PQ.qmax(kd) == RQ.qmax(kd)
        assert PQ.kv_dtype_of(torch.zeros(1, dtype=PQ.storage_dtype(kd))) == kd
    with pytest.raises(ValueError, match="kv_dtype"):
        PQ.validate_kv_dtype("int4")


def _write_case(seed, kv_dtype, *, nb=6, bs=8, hkv=2, hd=16):
    """A quantized pool with live scales, and a (B=3, S=4) write: row 0
    fills a fresh page from offset 0 (its stale scale must be ignored) and
    crosses into the next page, row 1 writes twice into one page mid-page,
    row 2 (a padding row) writes into trash block 0."""
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32) * 2.0
    scale = np.asarray(RQ.scales_of(jnp.asarray(full), kv_dtype)) * 4.0  # stale, large
    codes = RQ.quantize(jnp.asarray(full), jnp.asarray(scale), kv_dtype)
    rows = rng.standard_normal((3, 4, hkv, hd)).astype(np.float32) * 3.0
    page = np.array([[2, 2, 3, 3], [4, 4, 4, 4], [0, 0, 0, 0]], np.int32)
    off = np.array([[6, 7, 0, 1], [2, 3, 4, 5], [0, 1, 2, 3]], np.int32)
    return codes, scale, rows, page, off


@pytest.mark.parametrize("kv_dtype", KV)
def test_quant_paged_write_bit_equal_to_reference(kv_dtype):
    codes, scale, rows, page, off = _write_case(2, kv_dtype)
    c_r, s_r = RA._quant_paged_write(codes, jnp.asarray(scale), jnp.asarray(rows),
                                     jnp.asarray(page), jnp.asarray(off), kv_dtype)
    pool = torch.from_numpy(_codes(codes).copy())
    if kv_dtype == "fp8":
        pool = pool.view(torch.float8_e4m3fn)
    spool = torch.from_numpy(scale.copy())
    PA._quant_paged_write(pool, spool, torch.from_numpy(rows),
                          torch.from_numpy(page).long(), torch.from_numpy(off).long(),
                          kv_dtype)
    live = slice(1, None)  # trash block 0 holds unspecified garbage
    np.testing.assert_array_equal(_codes(pool)[live], _codes(c_r)[live])
    np.testing.assert_array_equal(spool.numpy()[live], np.asarray(s_r)[live])
    # Page 3 was written from offset 0: its scale covers only the new rows.
    np.testing.assert_array_equal(
        spool[3].numpy(), np.abs(rows[0, 2:]).max(axis=-1).max(axis=0) / PQ.qmax(kv_dtype))
