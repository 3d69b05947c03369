"""The port's attention kernels on the CPU: plain versions against the JAX
package (the Pallas kernels in interpret mode, the jnp references) and the
wrappers' input checks, for single-token and draft-block (``q_len > 1``)
paged decode over full-precision and int8 / fp8 pools, and prefill.  The
kernels themselves run only on a card: ``tests/test_torch_cuda.py``.

Tolerance: f32 plain vs JAX 2e-5 abs/rel (sums in another order, as the
reference's own kernel tests allow); the draft-block and quantized entries
vs their ``kernels/ref.py`` oracles 1e-5."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import quant as rquant
from repro.kernels import ref as rref
from repro.models import attention as rattn
from repro_torch.kernels import ops

TOL = dict(atol=2e-5, rtol=2e-5)


def _paged_case(seed, *, b=3, hkv=2, g=2, hd=16, bs=8, n_pages=4, cur=None,
                trash_row=None):
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_pages
    q = rng.standard_normal((b, hkv * g, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    kp[0] *= 100.0  # trash-page garbage must never contribute
    vp[0] *= 100.0
    pt = (rng.permutation(nb - 1)[: b * n_pages] + 1).reshape(b, n_pages)
    cl = (np.asarray(cur) if cur is not None
          else rng.integers(0, n_pages * bs, b)).astype(np.int32)
    for i in range(b):  # entries past cur_len point at trash, as in the engine
        pt[i, cl[i] // bs + 1:] = 0
    if trash_row is not None:  # shielded / free slot: all-trash row at 0
        pt[trash_row] = 0
        cl[trash_row] = 0
    return q, kp, vp, pt.astype(np.int32), cl


PAGED_CASES = [
    dict(cur=[0, 5, 9]),  # cur_len 0
    dict(cur=[8, 16, 24]),  # page-aligned
    dict(cur=[31, 31, 30]),  # last position of the table
    dict(cur=[0, 17, 31], trash_row=0),  # all-trash row
    dict(cur=[29, 12, 20], window=11),
    dict(cur=[29, 12, 20], softcap=20.0),
    dict(cur=[29, 3, 25], window=7, softcap=15.0),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: str(c))
def test_paged_plain_matches_reference(case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    q, kp, vp, pt, cl = _paged_case(3, cur=case["cur"], trash_row=case.get("trash_row"))
    got = ops.paged_attention(*map(torch.from_numpy, (q, kp, vp, pt, cl)),
                              scale=0.25, **kw).numpy()
    pallas = rops.paged_attention(*map(jnp.asarray, (q, kp, vp, pt, cl)),
                                  scale=0.25, **kw)
    oracle = rref.paged_attention_ref(*map(jnp.asarray, (q, kp, vp, pt, cl)),
                                      scale=0.25, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    assert np.isfinite(got).all()


def test_paged_default_scale_is_inverse_sqrt_head_dim():
    q, kp, vp, pt, cl = map(torch.from_numpy, _paged_case(5))
    np.testing.assert_array_equal(
        ops.paged_attention(q, kp, vp, pt, cl).numpy(),
        ops.paged_attention(q, kp, vp, pt, cl, scale=1 / math.sqrt(16)).numpy())


FLASH_CASES = [
    dict(sq=16, q_offset=0),
    dict(sq=16, q_offset=32),  # a later chunk of a prompt
    dict(sq=11, q_offset=21),  # ragged chunk and context
    dict(sq=5, q_offset=0, g=1),  # no GQA
    dict(sq=24, q_offset=8, window=9),
    dict(sq=24, q_offset=8, softcap=20.0),
    dict(sq=13, q_offset=6, window=5, softcap=10.0, g=4),
]


def _flash_case(seed, *, sq, q_offset, g=2, hkv=2, hd=16, b=2):
    rng = np.random.default_rng(seed)
    sk = q_offset + sq
    q = rng.standard_normal((b, sq, hkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: str(c))
def test_flash_plain_matches_flash_attention_ref(case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    q, k, v = _flash_case(1, sq=case["sq"], q_offset=case["q_offset"],
                          g=case.get("g", 2))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_offset=case["q_offset"], **kw).numpy()
    want = rattn.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), chunk=8, q_offset=case["q_offset"],
        window=kw.get("window", 0), softcap_val=kw.get("softcap", 0.0))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(window=7), dict(softcap=20.0)],
                         ids=lambda c: str(c))
def test_flash_plain_matches_pallas_kernel(kw):
    """Block-divisible shapes, q_offset 0: the Pallas kernel in interpret
    mode, GQA by its caller-side broadcast."""
    q, k, v = _flash_case(2, sq=32, q_offset=0)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = rops.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=16,
                                block_k=16, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_paged_wrapper_rejects_bad_inputs():
    q, kp, vp, pt, cl = map(torch.from_numpy, _paged_case(4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.paged_attention(q.half(), kp.half(), vp.half(), pt, cl)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, kp, vp, pt.long(), cl)
    with pytest.raises(ValueError, match="page_table"):
        ops.paged_attention(q, kp, vp, pt[:2], cl)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q[..., :8].contiguous(), kp, vp, pt, cl)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            kp, vp, pt, cl)
    with pytest.raises(ValueError, match="device"):
        ops.paged_attention(q.to("meta"), kp.to("meta"), vp.to("meta"),
                            pt.to("meta"), cl.to("meta"))


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = map(torch.from_numpy, _flash_case(4, sq=8, q_offset=4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, k[..., :8].contiguous(), v[..., :8].contiguous())
    with pytest.raises(ValueError, match="want q"):
        ops.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# -- q_len > 1 and quantized pools (speculative verify, int8 / fp8 pages) ----------

REF_TOL = dict(atol=1e-5, rtol=1e-5)  # plain vs the jnp oracle, both f32


def _multi_case(seed, t, cur, *, trash_row=None, b=3, hkv=2, g=2, hd=16, bs=8,
                n_pages=4):
    """A (B, T, H, hd) draft block per row at positions cur..cur+T-1; table
    entries past a row's last position point at trash, as in the engine,
    and a block may run past the table."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_pages
    q = rng.standard_normal((b, t, hkv * g, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    kp[0] *= 100.0  # trash-page garbage must never contribute
    vp[0] *= 100.0
    pt = (rng.permutation(nb - 1)[: b * n_pages] + 1).reshape(b, n_pages)
    cl = np.asarray(cur, np.int32)
    for i in range(b):
        pt[i, (cl[i] + t - 1) // bs + 1:] = 0
    if trash_row is not None:  # shielded / free slot: all-trash row at 0
        pt[trash_row] = 0
        cl[trash_row] = 0
    return q, kp, vp, pt.astype(np.int32), cl


MULTI_CASES = [
    dict(t=2, cur=[0, 9, 20]),
    dict(t=5, cur=[3, 14, 20]),  # row 1 crosses a page edge (14..18)
    dict(t=5, cur=[29, 6, 30]),  # rows 0 and 2 run past the table (32 positions)
    dict(t=5, cur=[0, 17, 26], trash_row=0),  # an all-trash row
    dict(t=5, cur=[21, 12, 25], window=6),
    dict(t=2, cur=[21, 12, 25], softcap=15.0),
    dict(t=5, cur=[22, 3, 17], window=9, softcap=20.0),
]


@pytest.mark.parametrize("case", MULTI_CASES, ids=lambda c: str(c))
def test_paged_multi_plain_matches_reference(case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    arrs = _multi_case(6, case["t"], case["cur"], trash_row=case.get("trash_row"))
    got = ops.paged_attention_multi(*map(torch.from_numpy, arrs), scale=0.25, **kw).numpy()
    want = rref.paged_attention_multi_ref(*map(jnp.asarray, arrs), scale=0.25, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **REF_TOL)
    assert got.shape == arrs[0].shape and np.isfinite(got).all()


@pytest.mark.parametrize("case", [MULTI_CASES[1], MULTI_CASES[6]], ids=lambda c: str(c))
def test_paged_multi_plain_matches_pallas_kernel(case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    arrs = _multi_case(7, case["t"], case["cur"], trash_row=case.get("trash_row"))
    got = ops.paged_attention_multi(*map(torch.from_numpy, arrs), **kw).numpy()
    want = rops.paged_attention_multi(*map(jnp.asarray, arrs), **kw)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_paged_multi_with_one_token_equals_single_token():
    q, kp, vp, pt, cl = map(torch.from_numpy, _multi_case(8, 1, [5, 17, 31]))
    np.testing.assert_array_equal(
        ops.paged_attention_multi(q, kp, vp, pt, cl)[:, 0].numpy(),
        ops.paged_attention(q[:, 0].contiguous(), kp, vp, pt, cl).numpy())


def _quantized(kp, vp, kv_dtype):
    """Reference-quantized pools: (k codes, v codes, k scales, v scales) as
    numpy (fp8 codes in the reference's ml_dtypes type)."""
    out = []
    for pool in (kp, vp):
        s = rquant.scales_of(jnp.asarray(pool), kv_dtype)
        out.append((np.array(rquant.quantize(jnp.asarray(pool), s, kv_dtype)),
                    np.array(s)))
    (kc, ks), (vc, vs) = out
    return kc, vc, ks, vs


def _torch_codes(a):
    if a.dtype == np.int8:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)


QUANT_CASES = [
    dict(t=1, cur=[0, 9, 31]),
    dict(t=1, cur=[0, 17, 26], trash_row=0, window=7),
    dict(t=2, cur=[0, 9, 20], softcap=15.0),
    dict(t=5, cur=[3, 14, 20]),  # a page edge
    dict(t=5, cur=[29, 6, 30]),  # past the table
    dict(t=5, cur=[0, 17, 26], trash_row=0),
    dict(t=5, cur=[22, 3, 17], window=9, softcap=20.0),
]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", QUANT_CASES, ids=lambda c: str(c))
def test_paged_quant_plain_matches_reference(case, kv_dtype):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    q, kp, vp, pt, cl = _multi_case(9, case["t"], case["cur"],
                                    trash_row=case.get("trash_row"))
    kc, vc, ks, vs = _quantized(kp, vp, kv_dtype)
    if case["t"] == 1:
        q = q[:, 0].copy()
        port, oracle = ops.paged_attention_quant, rref.paged_attention_quant_ref
    else:
        port, oracle = ops.paged_attention_multi_quant, rref.paged_attention_multi_quant_ref
    got = port(torch.from_numpy(q), _torch_codes(kc), _torch_codes(vc),
               torch.from_numpy(ks), torch.from_numpy(vs), torch.from_numpy(pt),
               torch.from_numpy(cl), scale=0.25, **kw).numpy()
    want = oracle(*map(jnp.asarray, (q, kc, vc, ks, vs, pt, cl)), scale=0.25, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **REF_TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_paged_quant_plain_matches_pallas_kernels(kv_dtype):
    q, kp, vp, pt, cl = _multi_case(10, 5, [3, 14, 20])
    kc, vc, ks, vs = _quantized(kp, vp, kv_dtype)
    pools = (_torch_codes(kc), _torch_codes(vc), torch.from_numpy(ks), torch.from_numpy(vs),
             torch.from_numpy(pt), torch.from_numpy(cl))
    jpools = tuple(map(jnp.asarray, (kc, vc, ks, vs, pt, cl)))
    got = ops.paged_attention_multi_quant(torch.from_numpy(q), *pools, window=9).numpy()
    want = rops.paged_attention_multi_quant(jnp.asarray(q), *jpools, window=9)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    q1 = q[:, 0].copy()
    got = ops.paged_attention_quant(torch.from_numpy(q1), *pools, softcap=20.0).numpy()
    want = rops.paged_attention_quant(jnp.asarray(q1), *jpools, softcap=20.0)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_multi_and_quant_wrappers_reject_bad_inputs():
    q, kp, vp, pt, cl = map(torch.from_numpy, _multi_case(11, 3, [1, 2, 3]))
    codes = kp.to(torch.int8)
    sc = torch.ones((kp.shape[0], kp.shape[2]))
    with pytest.raises(ValueError, match="want q"):
        ops.paged_attention_multi(q[:, 0].contiguous(), kp, vp, pt, cl)
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        ops.paged_attention_multi_quant(q, kp, vp, sc, sc, pt, cl)
    with pytest.raises(ValueError, match="float32"):
        ops.paged_attention_multi_quant(q, codes, codes, sc.double(), sc, pt, cl)
    with pytest.raises(ValueError, match="num_blocks, Hkv"):
        ops.paged_attention_quant(q[:, 0].contiguous(), codes, codes, sc[1:], sc, pt, cl)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.paged_attention_multi(q, codes, codes, pt, cl)
