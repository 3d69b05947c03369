"""The port's CUDA kernels on a card: each against its plain version, and
the engine (paged, contiguous, scatter-after-prefill, under page pressure,
sharing a prefix, at temperature) on the card against the engine on the
CPU, with the copy-on-write fork and the sampler's hash on the card; the
paged and prefill kernels at the zoo's grouped-query ratios (g = 2, 3, 6)
with gemma2's query scale and softcap; the prefill kernel with
paligemma's bidirectional prefix (``prefix_len``) and whisper's non-causal
attention over 1500 frames, the paged kernel at whisper's hd 64 / g 1 and
the SSD scan at jamba's H 128, P 128; graphed steps (qwen3, mamba2, a MoE
config, whisper and jamba) against their eager runs; the engine's stage
probe leaving a live pool or slot cache as it was with slots active, and
``autotune``'s pool rebuild dropping every graph over the old pool; the
analyzer's quant contract through the quantized kernels and its live sync
audit (a clean tick passes, a planted ``.item()`` raises).  Every
test carries
the ``cuda`` marker and skips without a card.  The file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances (max abs, kernel vs plain): f32 1e-5 (sums in another order),
bf16 2e-2 (one bf16 ulp at the outputs' magnitude).  The SSD scan's
outputs are not O(1) (sums over a chunk and a carried state), so its
tolerances are relative to the plain output's largest magnitude: f32 1e-4
(inside a 256-token chunk the cumulative log-decay reaches hundreds, and
one f32 ulp of it is a ~1e-5 relative error in each decay factor, summed in
another order by kernel and plain; 1e-4 is the reference's own tolerance
for its SSD kernel), bf16 2e-2.  The paper kernels, relative to the plain
output's largest magnitude (at least 1): matmul f32 1e-5 (k-long f32 sums
in another order), bf16 2e-2 (one bf16 ulp); FWT and NW exact (the same
f32 operations, in the same order, as the plain version).  P over code
pools (``ref.cancelling_quant_case``, bf16 q, output ~1e-7 while sum |p
v| / l is ~2.5): 1e-4, ten times what P at f32 accuracy
leaves there (<= 8e-6 in the plain emulation) and a thirtieth of what P
rounded once to bf16 leaves (>= 2.7e-3).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import streams, wavefront
from repro_torch.kernels import _build
from repro_torch.kernels import fwt as FWT
from repro_torch.kernels import nw_tile as NW
from repro_torch.kernels import ref
from repro_torch.kernels import streamed_matmul as MM
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import quant
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.models import transformer as T
from repro_torch.runtime import kv_cache, sampling, serving

pytestmark = pytest.mark.cuda
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = list(ATOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _paged(dtype, cur, *, trash_row=None, b=4, hkv=8, g=4, hd=128, bs=16, n_pages=9,
           seed=0):
    gen = torch.Generator().manual_seed(seed)
    nb = 1 + b * n_pages
    q = torch.randn((b, hkv * g, hd), generator=gen)
    kp = torch.randn((nb, bs, hkv, hd), generator=gen)
    vp = torch.randn((nb, bs, hkv, hd), generator=gen)
    kp[0] *= 100.0  # trash-page garbage must never contribute
    vp[0] *= 100.0
    pt = (torch.randperm(nb - 1, generator=gen)[: b * n_pages] + 1).reshape(b, n_pages)
    cl = torch.tensor(cur)
    for i in range(b):  # entries past cur_len point at trash, as in the engine
        pt[i, int(cl[i]) // bs + 1:] = 0
    if trash_row is not None:  # a shielded / free slot
        pt[trash_row] = 0
        cl[trash_row] = 0
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), pt.to(torch.int32),
            cl.to(torch.int32))


MULTI_CASES = [
    dict(t=5, cur=[139, 111, 88, 76]),  # the verify step's shapes
    dict(t=2, cur=[0, 15, 16, 100], trash_row=0),
    dict(t=5, cur=[14, 30, 60, 141]),  # page edges; row 3 runs past the table
    dict(t=5, cur=[139, 111, 88, 0], window=32, softcap=30.0, trash_row=3),
    dict(t=5, cur=[7, 3, 12, 0], hd=64, g=2, bs=8),
    dict(t=3, cur=[40, 7, 12, 21], g=8),  # 24 rows
    dict(t=17, cur=[120, 100, 64, 3]),  # 68 rows: two row tiles of 34
    dict(t=5, cur=[139, 111, 88, 76], g=1),
    dict(t=5, cur=[139, 111, 88, 76], g=8),
    dict(t=5, cur=[60, 33, 17, 0], hd=64),
    dict(t=5, cur=[139, 111, 88, 76], hd=256),
    dict(t=5, cur=[139, 130, 127, 100], window=16),  # whole splits behind the window
    dict(t=5, cur=[2043, 2027, 2011, 1995], n_pages=128),  # 8 pages a split
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    dict(cur=[0, 15, 16, 100], trash_row=0),
    dict(cur=[143, 100, 15, 16]),
    dict(cur=[143, 100, 15, 16], window=32),
    dict(cur=[143, 100, 15, 0], softcap=30.0, trash_row=3),
    dict(cur=[7, 3, 12, 0], hd=64, g=2, bs=8),
    *({k: v for k, v in c.items() if k != "t"} for c in MULTI_CASES),
], ids=str)
def test_paged_kernel_matches_plain(cuda, dtype, case):
    """Also at the draft-block cases' shapes with one token: 128 pages,
    head_dim 64 and 256, g 1 and 8, block size 8, whole splits behind the
    window."""
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    shape = {k: case[k] for k in ("hd", "g", "bs", "n_pages") if k in case}
    q, kp, vp, pt, cl = (t.to(cuda) for t in _paged(
        dtype, case["cur"], trash_row=case.get("trash_row"), **shape))
    n0 = PA.KERNEL.launches
    got = ops.paged_attention(q, kp, vp, pt, cl, **kw)
    want = PA.paged_attention_plain(q, kp, vp, pt, cl,
                                    scale=1 / math.sqrt(q.shape[-1]), **kw)
    torch.cuda.synchronize()
    assert PA.KERNEL.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


FLASH_CASES = [
    dict(sq=64, q_offset=0), dict(sq=64, q_offset=64), dict(sq=36, q_offset=64),
    dict(sq=5, q_offset=0, g=1), dict(sq=64, q_offset=64, window=32, softcap=30.0),
    dict(sq=13, q_offset=6, window=5, hd=16, b=2),
    # the long context; head_dim 64 and 256, g 1 and 8, Sq not a multiple
    # of 16; longer prefill chunks; a head_dim that is not a multiple of 16
    # (the SIMT body in bf16 too)
    dict(sq=64, q_offset=1984), dict(sq=37, q_offset=1984, hd=64, g=8),
    dict(sq=21, q_offset=100, hd=256, g=1), dict(sq=13, q_offset=5, hd=256, g=8, window=7,
                                                  softcap=20.0),
    dict(sq=50, q_offset=30, hd=64, g=1, b=3, window=40), dict(sq=512, q_offset=0),
    dict(sq=160, q_offset=32, window=100), dict(sq=19, q_offset=9, hd=24, g=1),
]


def _flash_case(cuda, dtype, case):
    """q, k, v on the card for a FLASH_CASES entry, its window / softcap
    keywords, and the tensor-core body's plan for it."""
    gen = torch.Generator().manual_seed(1)
    b, hd, hkv, g = case.get("b", 1), case.get("hd", 128), 8, case.get("g", 4)
    sq, off = case["sq"], case["q_offset"]
    q = torch.randn((b, sq, hkv * g, hd), generator=gen).to(cuda, dtype)
    k = torch.randn((b, off + sq, hkv, hd), generator=gen).to(cuda, dtype)
    v = torch.randn((b, off + sq, hkv, hd), generator=gen).to(cuda, dtype)
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    return (q, k, v), kw, FA.plan_flash(b, sq, hkv * g, hkv, hd, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    (q, k, v), kw, plan = _flash_case(cuda, dtype, case)
    hd, off = q.shape[-1], case["q_offset"]
    # bf16 with head_dim % 16 == 0 runs the tensor-core body, all else SIMT
    assert plan.body == ("tc" if dtype == torch.bfloat16 and hd % 16 == 0 else "simt")
    n0 = FA.KERNEL.launches
    got = ops.flash_attention(q, k, v, q_offset=off, **kw)
    want = FA.flash_attention_plain(q, k, v, scale=1 / math.sqrt(hd), q_offset=off, **kw)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c.get("hd", 128) % 16 == 0],
                         ids=str)
def test_flash_tc_kernel_matches_its_emulation(cuda, case):
    """The tensor-core body computes what ``ref.flash_attention_tc_plain``
    models (bf16 P per 16-key tile, the plan's key splits; run on the CPU):
    within 2 bf16 ulps of the output's largest magnitude, the tolerance the
    CPU tests hold the emulation's key splits to against JAX."""
    (q, k, v), kw, plan = _flash_case(cuda, torch.bfloat16, case)
    assert plan.body == "tc"
    got = ops.flash_attention(q, k, v, q_offset=case["q_offset"], **kw).float().cpu()
    want = ref.flash_attention_tc_plain(
        q.cpu(), k.cpu(), v.cpu(), q_offset=case["q_offset"], key_tile=plan.key_tile,
        key_splits=plan.key_splits, **kw).float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= 2 * ulp


# paligemma (hd 256, g 8, one kv head): its first chunk (256 image rows +
# 64 tokens), a later chunk, a ragged prefix, a prefix past a later chunk's
# causal limit, and a small head_dim (the SIMT body in bf16 too).
PREFIX_CASES = [dict(sq=320, sk=320, q_offset=0, prefix_len=256),
                dict(sq=64, sk=384, q_offset=320, prefix_len=256),
                dict(sq=90, sk=90, q_offset=0, prefix_len=70),
                dict(sq=48, sk=300, q_offset=200, prefix_len=280),
                dict(sq=20, sk=20, q_offset=0, prefix_len=8, hd=24, g=4)]
# whisper (hd 64, g 1, 16 heads): the encoder (1500 x 1500), a chunk's
# cross-attention (64 and 37 rows over 1500 frames), and GQA over a short
# context.
NONCAUSAL_CASES = [dict(sq=1500, sk=1500), dict(sq=64, sk=1500), dict(sq=37, sk=1500),
                   dict(sq=64, sk=100, hd=128, g=4, hkv=8)]


def _attn_inputs(cuda, dtype, case, *, hd, g, hkv):
    gen = torch.Generator().manual_seed(5)
    hd, g, hkv = case.get("hd", hd), case.get("g", g), case.get("hkv", hkv)
    q = torch.randn((1, case["sq"], hkv * g, hd), generator=gen).to(cuda, dtype)
    k = torch.randn((1, case["sk"], hkv, hd), generator=gen).to(cuda, dtype)
    v = torch.randn((1, case["sk"], hkv, hd), generator=gen).to(cuda, dtype)
    return q, k, v


def _held_flash(q, k, v, dtype, **kw):
    """The kernel (one launch) against the plain version; bf16 tensor-core
    calls also against the body's emulation (2 bf16 ulps, as
    ``test_flash_tc_kernel_matches_its_emulation``)."""
    hd = q.shape[-1]
    n0 = FA.KERNEL.launches
    got = ops.flash_attention(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, scale=1 / math.sqrt(hd), **kw)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
    plan = FA.plan_flash(q.shape[0], q.shape[1], q.shape[2], k.shape[2], hd, dtype)
    if plan.body == "tc":
        emul = ref.flash_attention_tc_plain(q.cpu(), k.cpu(), v.cpu(), key_tile=plan.key_tile,
                                            key_splits=plan.key_splits, **kw).float()
        ulp = 2.0 ** (math.floor(math.log2(emul.abs().max().item())) - 7)
        assert (got.float().cpu() - emul).abs().max().item() <= 2 * ulp


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", PREFIX_CASES, ids=str)
def test_flash_kernel_with_prefix_matches_plain(cuda, dtype, case):
    q, k, v = _attn_inputs(cuda, dtype, case, hd=256, g=8, hkv=1)
    _held_flash(q, k, v, dtype, q_offset=case["q_offset"], prefix_len=case["prefix_len"])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", NONCAUSAL_CASES, ids=str)
def test_flash_kernel_non_causal_matches_plain(cuda, dtype, case):
    q, k, v = _attn_inputs(cuda, dtype, case, hd=64, g=1, hkv=16)
    _held_flash(q, k, v, dtype, causal=False)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_kernel_at_whisper_widths_matches_plain(cuda, dtype):
    q, kp, vp, pt, cl = (t.to(cuda) for t in _paged(dtype, [143, 100, 15, 0], trash_row=3,
                                                      hkv=16, g=1, hd=64))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = ops.paged_attention(q, kp, vp, pt, cl)
    want = PA.paged_attention_plain(q, kp, vp, pt, cl, scale=1 / 8)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def test_kernel_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    q, kp, vp, pt, cl = (t.to(cuda) for t in _paged(torch.float32, [1, 2, 3, 4]))
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros((4, 32, 320), device=cuda)
        pool = torch.zeros((*kp.shape[:3], 320), device=cuda)
        ops.paged_attention(wide, pool, pool, pt, cl)
    with pytest.raises(ValueError, match="device"):
        ops.paged_attention(q.cpu(), kp, vp, pt, cl)
    codes = kp.to(torch.int8)
    sc = torch.ones((kp.shape[0], kp.shape[2]), device=cuda)
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        ops.paged_attention_quant(q, kp.half(), vp.half(), sc, sc, pt, cl)
    with pytest.raises(ValueError, match="num_blocks, Hkv"):
        ops.paged_attention_multi_quant(q[:, None], codes, codes, sc[1:], sc, pt, cl)
    # The draft-block kernel takes head_dim in multiples of 16 (the
    # single-token one any head_dim up to 256).
    q24 = torch.zeros((4, 2, 32, 24), device=cuda)
    pool24 = torch.zeros((*kp.shape[:3], 24), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.paged_attention_multi(q24, pool24, pool24, pt, cl)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.paged_attention_multi_quant(q24, pool24.to(torch.int8), pool24.to(torch.int8),
                                        sc, sc, pt, cl)
    assert ops.paged_attention(q24[:, 0].contiguous(), pool24, pool24, pt, cl).shape == (4, 32, 24)
    # The walk body (head_dim 24) holds at most 16 query heads per kv head;
    # the split body (head_dim 128) needs q and pools on 16-byte boundaries.
    pool24_1 = torch.zeros((kp.shape[0], kp.shape[1], 1, 24), device=cuda)
    with pytest.raises(ValueError, match="query heads per kv head"):
        ops.paged_attention(q24[:, 0].contiguous(), pool24_1, pool24_1, pt, cl)
    q_off = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention(q_off, kp, vp, pt, cl)
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention_quant(q_off, codes, codes, sc, sc, pt, cl)
    # The prefill kernel's tensor-core body copies q, k, v in 16-byte chunks.
    kf = torch.zeros((1, 8, 8, 128), device=cuda, dtype=torch.bfloat16)
    qf = torch.zeros(8 * 32 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(qf.view(1, 8, 32, 128), kf, kf, scale=1.0)


def _quantize(pool, kv_dtype):
    """(codes, scales) of a full-precision pool, the port's own quantizer."""
    scale = quant.scales_of(pool, kv_dtype)
    return quant.quantize(pool, scale, kv_dtype), scale


def _draft_inputs(dtype, case, cuda):
    shape = {k: case[k] for k in ("hd", "g", "bs", "n_pages") if k in case}
    t = case["t"]
    q, kp, vp, pt, cl = _paged(dtype, case["cur"], trash_row=case.get("trash_row"),
                               **shape)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((q.shape[0], t, *q.shape[1:]), generator=gen).to(dtype)
    # Trash garbage at ordinary magnitude: a draft row attends several
    # trash keys, and x100 outputs would round past the bf16 tolerance.
    kp[0] /= 100.0
    vp[0] /= 100.0
    for i in range(pt.shape[0]):  # keep the pages of the whole draft block
        last = int(cl[i]) + t - 1
        if case.get("trash_row") != i and last // kp.shape[1] < pt.shape[1]:
            pt[i, last // kp.shape[1]] = kp.shape[0] - 1 - i
    return [x.to(cuda) for x in (q, kp, vp, pt, cl)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", MULTI_CASES, ids=str)
def test_paged_multi_kernel_matches_plain(cuda, dtype, case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    q, kp, vp, pt, cl = _draft_inputs(dtype, case, cuda)
    n0 = PA.MULTI_KERNEL.launches
    got = ops.paged_attention_multi(q, kp, vp, pt, cl, **kw)
    want = PA.paged_attention_multi_plain(q, kp, vp, pt, cl,
                                          scale=1 / math.sqrt(q.shape[-1]), **kw)
    torch.cuda.synchronize()
    assert PA.MULTI_KERNEL.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [dict(t=1, cur=[143, 100, 15, 16]),
                                  dict(t=1, cur=[0, 15, 16, 100], trash_row=0, window=32),
                                  *MULTI_CASES, *(dict(c, t=1) for c in MULTI_CASES)], ids=str)
def test_paged_quant_kernels_match_plain(cuda, dtype, kv_dtype, case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    q, kp, vp, pt, cl = _draft_inputs(dtype, case, cuda)
    (kc, ks), (vc, vs) = _quantize(kp.float(), kv_dtype), _quantize(vp.float(), kv_dtype)
    scale = 1 / math.sqrt(q.shape[-1])
    if case["t"] == 1:
        q, kern = q[:, 0].contiguous(), PA.QUANT_KERNEL
        fn, plain = ops.paged_attention_quant, PA.paged_attention_quant_plain
    else:
        kern = PA.MULTI_QUANT_KERNEL
        fn, plain = ops.paged_attention_multi_quant, PA.paged_attention_multi_quant_plain
    n0 = kern.launches
    got = fn(q, kc, vc, ks, vs, pt, cl, **kw)
    want = plain(q, kc, vc, ks, vs, pt, cl, scale=scale, **kw)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


# The zoo's grouped-query ratios (gemma2 g = 2, phi4-mini 3, internlm2 6) at
# head_dim 128 with gemma2's query scale and softcap 50: q_len 1, a verify
# block of 5, and blocks of 68-72 rows (two row tiles); a window that bites.
ZOO_SCALE = 144 ** -0.5
ZOO_CASES = [dict(g=g, t=t, cur=[139, 111, 88, 40], softcap=50.0, n_pages=12, **w)
             for g, t_long in ((2, 34), (3, 23), (6, 12)) for t in (1, 5, t_long)
             for w in ({}, dict(window=24))]


@pytest.mark.parametrize("pool", ["full", "int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ZOO_CASES, ids=str)
def test_paged_kernels_at_zoo_groups_match_plain(cuda, dtype, pool, case):
    kw = dict(window=case.get("window", 0), softcap=case["softcap"], scale=ZOO_SCALE)
    q, kp, vp, pt, cl = _draft_inputs(dtype, case, cuda)
    if case["t"] == 1:
        q = q[:, 0].contiguous()
    single = case["t"] == 1
    if pool == "full":
        args = (q, kp, vp, pt, cl)
        kern = PA.KERNEL if single else PA.MULTI_KERNEL
        fn = ops.paged_attention if single else ops.paged_attention_multi
        plain = PA.paged_attention_plain if single else PA.paged_attention_multi_plain
    else:
        (kc, ks), (vc, vs) = _quantize(kp.float(), pool), _quantize(vp.float(), pool)
        args = (q, kc, vc, ks, vs, pt, cl)
        kern = PA.QUANT_KERNEL if single else PA.MULTI_QUANT_KERNEL
        fn = ops.paged_attention_quant if single else ops.paged_attention_multi_quant
        plain = (PA.paged_attention_quant_plain if single
                 else PA.paged_attention_multi_quant_plain)
    n0 = kern.launches
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [dict(g=g, sq=sq, q_offset=off, softcap=50.0, **w)
                                  for g in (2, 3, 6) for sq, off in ((64, 0), (64, 64), (36, 64))
                                  for w in ({}, dict(window=48))], ids=str)
def test_flash_kernel_at_zoo_groups_matches_plain(cuda, dtype, case):
    (q, k, v), kw, _ = _flash_case(cuda, dtype, case)
    n0 = FA.KERNEL.launches
    got = ops.flash_attention(q, k, v, q_offset=case["q_offset"], scale=ZOO_SCALE, **kw)
    want = FA.flash_attention_plain(q, k, v, scale=ZOO_SCALE, q_offset=case["q_offset"], **kw)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


P_CODES_ATOL = 1e-4  # see the module docstring


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quant_kernels_keep_p_at_f32_accuracy(cuda, kv_dtype, t):
    """bf16 q over code pools whose V values cancel: the kernel's P V must
    keep P at f32 accuracy, as the reference's f32 dequantized V does."""
    q, kc, vc, ks, vs, pt, cl = (x.to(cuda) for x in ref.cancelling_quant_case(3, t, kv_dtype))
    q = q.to(torch.bfloat16)
    if t == 1:
        q, kern = q[:, 0].contiguous(), PA.QUANT_KERNEL
        fn, plain = ops.paged_attention_quant, PA.paged_attention_quant_plain
    else:
        kern = PA.MULTI_QUANT_KERNEL
        fn, plain = ops.paged_attention_multi_quant, PA.paged_attention_multi_quant_plain
    n0 = kern.launches
    got = fn(q, kc, vc, ks, vs, pt, cl)
    want = plain(q, kc, vc, ks, vs, pt, cl, scale=1 / math.sqrt(q.shape[-1]))
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= P_CODES_ATOL, err


def test_engine_on_card_matches_cpu(cuda):
    """Smoke qwen3-4b (head_dim 16, 2 query heads per kv head) served on the
    card through both kernels and on the CPU through the plain versions:
    greedy tokens identical per request."""
    cfg = configs.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = serving.ServeConfig(max_seq=48, prefill_chunk=16, max_new_tokens=6,
                               max_batch=2, block_size=8, paged=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (24, 17, 40, 9, 33)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else {k: _to(v, cuda) for k, v in params.items()}
        eng = serving.StreamedBatchEngine(cfg, p, scfg, device=dev)
        uids = [eng.submit(t) for t in prompts]
        got = eng.run()
        out[dev] = [got[u] for u in uids]
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [dict(spec_decode=True, spec_k=4), dict(kv_dtype="int8"),
                                   dict(kv_dtype="fp8"),
                                   dict(kv_dtype="int8", spec_decode=True, spec_k=3)],
                         ids=str)
def test_spec_and_quantized_engines_on_card_match_cpu(cuda, extra):
    """Smoke qwen3-4b through the verify and fused-dequant kernels on the
    card and their plain versions on the CPU, on prompts that tile a
    segment (so prompt lookup drafts): greedy tokens identical per request
    (f32 pools agree to 1e-6; quantized codes can flip at a rounding edge,
    which at this size has not happened)."""
    cfg = configs.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = serving.ServeConfig(max_seq=48, prefill_chunk=16, max_new_tokens=10,
                               max_batch=2, block_size=8, paged=True, **extra)
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, n), 3).astype(np.int32)
               for n in (6, 5, 8, 4)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else {k: _to(v, cuda) for k, v in params.items()}
        eng = serving.StreamedBatchEngine(cfg, p, scfg, device=dev)
        uids = [eng.submit(t) for t in prompts]
        got = eng.run()
        out[dev] = [got[u] for u in uids]
        assert eng.kv.pages_in_use == 0
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a, b)


def _to(v, dev):
    return {k: _to(x, dev) for k, x in v.items()} if isinstance(v, dict) else v.to(dev)


def _serve_both(cfg, params, scfg, prompts, cuda):
    """Serve ``prompts`` on the CPU and on the card; returns {device:
    (engine, tokens per prompt, prefill-kernel launches)}."""
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else {k: _to(v, cuda) for k, v in params.items()}
        eng = serving.StreamedBatchEngine(cfg, p, serving.ServeConfig(**scfg), device=dev)
        n0 = FA.KERNEL.launches
        uids = [eng.submit(t) for t in prompts]
        got = eng.run()
        out[dev] = (eng, [got[u] for u in uids], FA.KERNEL.launches - n0)
        if eng.paged:
            eng.kv.clear_prefixes()  # the registry's retained pages, with sharing
            assert eng.kv.pages_in_use == 0
            eng.kv.check_invariants()
    return out


@pytest.mark.parametrize("extra", [dict(paged=False),
                                   dict(paged=False, spec_decode=True, spec_k=3),
                                   dict(paged=True, fused_prefill=False)], ids=str)
def test_contiguous_engines_on_card_match_cpu(cuda, extra):
    """Smoke qwen3-4b over the contiguous slot cache (plain and with spec
    decode) and over pages filled by scatter-after-prefill, on the card
    and on the CPU: greedy tokens identical per request, and every prefill
    chunk on the card through the prefill kernel (once a layer)."""
    cfg = configs.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = dict(max_seq=48, prefill_chunk=16, max_new_tokens=10, max_batch=2,
                block_size=8, **extra)
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, n), 3).astype(np.int32)
               for n in (6, 5, 8, 4)]
    out = _serve_both(cfg, params, scfg, prompts, cuda)
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        np.testing.assert_array_equal(a, b)
    eng, _, launches = out["cuda"]
    assert launches == cfg.n_layers * eng.prefill_chunks > 0
    assert eng.spec_accepted == out["cpu"][0].spec_accepted


def test_pressured_paged_engine_on_card_equals_unpressured(cuda):
    """A pool too small for both slots' growth preempts on the card as on
    the CPU (same count), and evict / readmit (a gather and a scatter of
    f32 pages, exact copies) leave the tokens of the unpressured serve."""
    cfg = configs.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = dict(max_seq=64, prefill_chunk=16, max_new_tokens=32, max_batch=2,
                block_size=16, paged=True)
    rng = np.random.default_rng(73)
    prompts = [rng.integers(0, cfg.vocab_size, 32).astype(np.int32) for _ in range(2)]
    free = _serve_both(cfg, params, scfg, prompts, cuda)
    tight = _serve_both(cfg, params, dict(scfg, num_blocks=8), prompts, cuda)
    assert tight["cuda"][0].preemptions == tight["cpu"][0].preemptions >= 1
    assert free["cuda"][0].preemptions == 0
    for a, b, c in zip(tight["cuda"][1], tight["cpu"][1], free["cuda"][1]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_cow_fork_on_card(cuda, kv_dtype):
    """The COW fork of a shared bf16 (or int8 with its scales) page on the
    card: the fork's codes and scale rows are bit-equal to the page's, and
    a write to the fork leaves the sharer's page as it was."""
    cfg = dataclasses.replace(configs.get_config("qwen3-4b"), n_layers=2)
    kv = kv_cache.PagedKVCache(cfg, max_batch=2, max_seq=64, block_size=16,
                               kv_dtype=kv_dtype, device=cuda)
    assert kv.alloc(0, 16)
    blk = kv.slot_pages(0)[0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    for c in kv.pools["blocks"].values():
        for key, leaf in c.items():
            rows = torch.randn(leaf[:, blk].shape, generator=gen, device=cuda)
            if key.endswith("_scale"):
                rows = rows.abs()
            elif leaf.dtype == torch.int8:
                rows = rows * 50
            leaf[:, blk] = rows.to(leaf.dtype)
    kv.map_shared(1, [blk])
    assert kv.ensure_write(1, 5)
    fork = kv.slot_pages(1)[0]
    torch.cuda.synchronize()
    assert fork != blk and kv.cow_forks == 1
    for c in kv.pools["blocks"].values():
        for key, leaf in c.items():
            assert torch.equal(leaf[:, fork], leaf[:, blk]), key
            assert leaf.device.type == "cuda"
    c0 = next(iter(kv.pools["blocks"].values()))
    before = c0["k"][:, blk].clone()
    c0["k"][:, fork] = 1
    assert torch.equal(c0["k"][:, blk], before)
    kv.check_invariants()


def test_shared_head_fused_prefill_on_card_equals_unshared(cuda):
    """Smoke qwen3-4b at f32 with prompts sharing a 2-page head: the shared
    serve on the card (its tails' chunks through the prefill kernel at
    q_offset = the head) gives the unshared serve's tokens and the CPU's,
    with the CPU's sharing counters and fewer prefill launches."""
    cfg = configs.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = dict(max_seq=96, prefill_chunk=16, max_new_tokens=8, max_batch=4,
                block_size=16, paged=True)
    rng = np.random.default_rng(41)
    head = rng.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, n)]).astype(np.int32)
               for n in (8, 16, 24, 8)]
    plain = _serve_both(cfg, params, scfg, prompts, cuda)
    shared = _serve_both(cfg, params, dict(scfg, prefix_sharing=True), prompts, cuda)
    for a, b, c in zip(shared["cuda"][1], shared["cpu"][1], plain["cuda"][1]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    eng, cpu = shared["cuda"][0], shared["cpu"][0]
    assert eng.prefix_hits == cpu.prefix_hits == 3
    assert eng.prefix_pages_shared == cpu.prefix_pages_shared
    assert eng.kv.peak_pages_in_use < plain["cuda"][0].kv.peak_pages_in_use
    assert shared["cuda"][2] < plain["cuda"][2]


def test_sampler_hash_bit_equal_on_card(cuda):
    """The stream keys and uniforms are integer arithmetic: bit-equal on
    the card and the CPU; a temperature serve on the card gives the same
    tokens paged and contiguous."""
    rng = np.random.default_rng(0)
    uids = torch.from_numpy(rng.integers(0, 2**31 - 1, 257))
    steps = torch.from_numpy(rng.integers(0, 2**31 - 1, 257))
    for tag in (0, 1, 2):
        k_cpu = sampling.stream_keys(uids, steps, tag=tag)
        k_gpu = sampling.stream_keys(uids.to(cuda), steps.to(cuda), tag=tag)
        assert torch.equal(k_gpu.cpu(), k_cpu)
        assert torch.equal(sampling.uniforms(k_gpu, 4096).cpu(),
                           sampling.uniforms(k_cpu, 4096))
    cfg = configs.get_smoke_config("qwen3-4b")
    params = {k: _to(v, cuda) for k, v in T.init_params(cfg, 0, device="cpu").items()}
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (24, 32, 40)]
    toks = []
    for paged in (False, True):
        eng = serving.StreamedBatchEngine(cfg, params, serving.ServeConfig(
            max_seq=64, prefill_chunk=16, max_new_tokens=8, max_batch=3, block_size=16,
            paged=paged, temperature=0.8), device=cuda)
        uids_ = [eng.submit(p) for p in prompts]
        out = eng.run()
        toks.append([out[u] for u in uids_])
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)


SSD_CASES = [dict(b=1, s=64, chunk=256), dict(b=1, s=36, chunk=256),
             dict(b=1, s=13, chunk=256, init=True), dict(b=2, s=512, chunk=256, init=True),
             dict(b=1, s=300, chunk=256), dict(b=2, s=100, chunk=64, init=True),
             dict(b=2, s=40, chunk=8, init=True, h=4, p=8, n=16)]


def _ssd_inputs(dtype, case, dev, seed=0):
    b, s = case["b"], case["s"]
    h, p, n = case.get("h", 8), case.get("p", 64), case.get("n", 128)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    a = -torch.exp(torch.linspace(-1.0, 1.0, h))
    bm = 0.3 * torch.randn((b, s, n), generator=gen)
    cm = 0.3 * torch.randn((b, s, n), generator=gen)
    st = torch.randn((b, h, p, n), generator=gen) if case.get("init") else None
    return (x.to(dtype).to(dev), dt.to(dev), a.to(dev), bm.to(dtype).to(dev),
            cm.to(dtype).to(dev), None if st is None else st.to(dev))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_matches_plain(cuda, dtype, case):
    """Aligned and ragged lengths, Q = 256 over several row tiles, chunk
    clamped to S, zero and random initial state: y and the final state."""
    x, dt, a, bm, cm, st = _ssd_inputs(dtype, case, cuda)
    n0 = SSD.KERNEL.launches
    y, f = SSD.ssd_chunked(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    y_p, f_p = SSD.ssd_chunked_plain(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    torch.cuda.synchronize()
    assert SSD.KERNEL.launches == n0 + 1
    assert y.dtype == x.dtype and f.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(f).all()
    ymax = max(1.0, y_p.float().abs().max().item())
    fmax = max(1.0, f_p.abs().max().item())
    assert (y.float() - y_p.float()).abs().max().item() <= SSD_RTOL[dtype] * ymax
    assert (f - f_p).abs().max().item() <= SSD_RTOL[torch.float32] * fmax


SSD_TC_CASES = [dict(b=1, s=64, chunk=256, init=True), dict(b=1, s=36, chunk=256),
                dict(b=2, s=13, chunk=256, init=True), dict(b=2, s=512, chunk=256, init=True),
                dict(b=1, s=300, chunk=256), dict(b=2, s=100, chunk=64, init=True),
                dict(b=1, s=64, chunk=64, init=True, n=32), dict(b=1, s=64, chunk=64, n=64),
                dict(b=1, s=130, chunk=256, init=True, n=256), dict(b=1, s=64, chunk=64, p=128)]
SSD_TC_ULPS = 4  # y: bf16 ulps of the emulation's largest magnitude


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [dict(b=1, s=64, chunk=256, init=True),
                                  dict(b=2, s=300, chunk=256),
                                  dict(b=1, s=512, chunk=256, init=True)], ids=str)
def test_ssd_kernel_at_jamba_widths_matches_plain(cuda, dtype, case):
    """jamba's mamba layers: H 128, P 128 (two 64-column blocks a head on
    the tensor-core body), N 128, chunk 256."""
    case = dict(case, h=128, p=128, n=128)
    x, dt, a, bm, cm, st = _ssd_inputs(dtype, case, cuda, seed=4)
    n0 = SSD.KERNEL.launches
    y, f = SSD.ssd_chunked(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    y_p, f_p = SSD.ssd_chunked_plain(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    torch.cuda.synchronize()
    assert SSD.KERNEL.launches == n0 + 1
    ymax = max(1.0, y_p.float().abs().max().item())
    fmax = max(1.0, f_p.abs().max().item())
    assert (y.float() - y_p.float()).abs().max().item() <= SSD_RTOL[dtype] * ymax
    assert (f - f_p).abs().max().item() <= SSD_RTOL[torch.float32] * fmax


@pytest.mark.parametrize("case", SSD_TC_CASES, ids=str)
def test_ssd_bf16_kernel_matches_tc_emulation(cuda, case):
    """The tensor-core body against its arithmetic on the CPU
    (``ref.ssd_chunked_tc_plain``: the same bf16 rounding points and the
    hi + lo split of the state update): y within a few bf16 ulps of the
    emulation's largest magnitude, the final state within SSD_RTOL[f32]."""
    x, dt, a, bm, cm, st = _ssd_inputs(torch.bfloat16, case, cuda, seed=3)
    n0 = SSD.KERNEL.launches
    y, f = SSD.ssd_chunked(x, dt, a, bm, cm, chunk=case["chunk"], init_state=st)
    torch.cuda.synchronize()
    assert SSD.KERNEL.launches == n0 + 1
    y_e, f_e = ref.ssd_chunked_tc_plain(
        *(t.cpu() for t in (x, dt, a, bm, cm)), chunk=case["chunk"],
        init_state=None if st is None else st.cpu())
    ymax = max(1.0, y_e.float().abs().max().item())
    ulp = 2.0 ** (math.floor(math.log2(ymax)) - 7)
    assert (y.cpu().float() - y_e.float()).abs().max().item() <= SSD_TC_ULPS * ulp
    fmax = max(1.0, f_e.abs().max().item())
    assert (f.cpu() - f_e).abs().max().item() <= SSD_RTOL[torch.float32] * fmax


def test_ops_ssd_launches_the_kernel(cuda):
    x, dt, a, bm, cm, _ = _ssd_inputs(torch.float32, dict(b=1, s=48, chunk=16), cuda)
    n0 = SSD.KERNEL.launches
    y = ops.ssd(x, dt, a, bm, cm, chunk=16)
    torch.cuda.synchronize()
    assert SSD.KERNEL.launches == n0 + 1
    torch.testing.assert_close(y, SSD.ssd_chunked_plain(x, dt, a, bm, cm, chunk=16)[0],
                               atol=SSD_RTOL[torch.float32] * max(1.0, y.abs().max().item()),
                               rtol=0)


@pytest.mark.parametrize("extra", [dict(paged=False), dict(paged=True),
                                   dict(paged=False, state_snapshots=True)], ids=str)
def test_mamba_engine_on_card_matches_cpu(cuda, extra):
    """Smoke mamba2 served on the card (the SSD kernel in every prefill
    chunk) and on the CPU: greedy tokens identical per request."""
    cfg = configs.get_smoke_config("mamba2-2.7b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = dict(max_seq=64, prefill_chunk=16, max_new_tokens=6, max_batch=2, **extra)
    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])
               for n in (24, 1, 17, 30)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else {k: _to(v, cuda) for k, v in params.items()}
        eng = serving.StreamedBatchEngine(cfg, p, serving.ServeConfig(**scfg), device=dev)
        n0 = SSD.KERNEL.launches
        uids = [eng.submit(t) for t in prompts]
        got = eng.run()
        out[dev] = ([got[u] for u in uids], eng.snapshot_hits)
        if dev == "cuda":
            assert SSD.KERNEL.launches - n0 == cfg.n_layers * eng.prefill_chunks
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        np.testing.assert_array_equal(a, b)
    assert out["cpu"][1] == out["cuda"][1]


# -- the paper kernels and the stream engine ---------------------------------------

PAPER_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _close(got, want, rtol):
    tol = rtol * max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)], ids=str)
@pytest.mark.parametrize("mkn", [(256, 256, 256), (512, 384, 640), (37, 53, 29),
                                 (129, 257, 130), (1, 1000, 1), (2048, 2048, 2048),
                                 (2047, 33, 2049), (2049, 33, 2047)], ids=str)
def test_matmul_kernel_matches_plain(cuda, dtypes, mkn):
    m, k, n = mkn
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtypes[0])
    y = torch.randn((k, n), generator=g, device=cuda).to(dtypes[1])
    n0 = MM.KERNEL.launches
    got = ops.matmul(x, y)
    torch.cuda.synchronize()
    assert MM.KERNEL.launches == n0 + 1
    assert got.dtype == torch.result_type(x, y) and got.shape == (m, n)
    _close(got, MM.matmul_plain(x, y), PAPER_RTOL[got.dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4096, 1024), (1024, 4096), (3, 8), (5, 1), (7, 2),
                                   (2, 1 << 14), (2, 1 << 15), (33, 32), (6, 64), (3, 256),
                                   (2, 512), (3, 2048)], ids=str)
def test_fwt_kernel_matches_plain(cuda, dtype, shape):
    """Every body (several rows a warp, a row in registers, a row through
    shared memory) runs the plain version's f32 operations: bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n0 = FWT.KERNEL.launches
    got = FWT.fwt_block(x)
    torch.cuda.synchronize()
    assert FWT.KERNEL.launches == n0 + 1 and got.dtype == dtype
    assert torch.equal(got, FWT.fwt_plain(x))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [
    (4096, 1024),  # pass 2 of a 2^22 task: 128 strips of 8 columns
    (2, 1024), (1, 8), (32, 33),
    (4096, 1020), (16, 1000),  # a last strip part outside b2 (16-byte copies)
    (64, 3), (1024, 20),  # rows of b2 not a multiple of 16 bytes: element copies
    (8192, 8), (1 << 14, 3), (1 << 15, 2),  # b1 large: strips of 4, 2, 1 columns
], ids=str)
def test_fwt_columns_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator(device="cuda").manual_seed(shape[0] + shape[1])
    y = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n0, r0 = FWT.COLUMNS_KERNEL.launches, FWT.KERNEL.launches
    got = FWT.fwt_columns(y)
    torch.cuda.synchronize()
    assert (FWT.COLUMNS_KERNEL.launches, FWT.KERNEL.launches) == (n0 + 1, r0)
    assert got.dtype == dtype and got.shape == y.shape
    assert torch.equal(got, FWT.fwt_columns_plain(y))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4096, 1024), (1024, 24), (64, 3)], ids=str)
def test_fwt_columns_in_place(cuda, dtype, shape):
    g = torch.Generator(device="cuda").manual_seed(7)
    y = torch.randn(shape, generator=g, device=cuda).to(dtype)
    want = FWT.fwt_columns_plain(y)
    got = FWT.fwt_columns(y, out=y)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr() and torch.equal(y, want)


@pytest.mark.parametrize("logn,block", [(10, 16), (11, None), (12, 64), (14, 256), (16, None),
                                        (18, 1024), (20, 512), (20, 32), (22, None),
                                        (22, 128)], ids=str)
def test_ops_fwt_bit_equal_on_card(cuda, logn, block):
    """The flat path, rows then columns, equals the whole-vector plain
    version bit for bit (its stages in the same order), in two launches."""
    g = torch.Generator(device="cuda").manual_seed(logn)
    x = torch.randn(1 << logn, generator=g, device=cuda)
    r0, c0 = FWT.KERNEL.launches, FWT.COLUMNS_KERNEL.launches
    got = ops.fwt(x, block=block)
    torch.cuda.synchronize()
    assert (FWT.KERNEL.launches, FWT.COLUMNS_KERNEL.launches) == (r0 + 1, c0 + 1)
    assert torch.equal(got, ref.fwt_ref(x))


@pytest.mark.parametrize("logn,block", [(14, None), (22, None), (12, 16)], ids=str)
def test_ops_fwt_bf16_flat_on_card(cuda, logn, block):
    """bf16: pass 1's output is rounded to bf16, as the reference's is."""
    g = torch.Generator(device="cuda").manual_seed(logn)
    x = torch.randn(1 << logn, generator=g, device=cuda).bfloat16()
    b2 = block or min(x.numel(), 1024)
    want = FWT.fwt_columns_plain(FWT.fwt_plain(x.reshape(-1, b2))).reshape(-1)
    assert torch.equal(ops.fwt(x, block=block), want)


def test_ops_fwt_on_card(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1 << 22, generator=g, device=cuda)
    n0, c0 = FWT.KERNEL.launches, FWT.COLUMNS_KERNEL.launches
    got = ops.fwt(x)
    torch.cuda.synchronize()
    # the two Kronecker passes: one row-pass and one column-pass launch
    assert (FWT.KERNEL.launches, FWT.COLUMNS_KERNEL.launches) == (n0 + 1, c0 + 1)
    assert torch.equal(got, ref.fwt_ref(x))
    rows = torch.randn((6, 512), generator=g, device=cuda)
    assert torch.equal(ops.fwt(rows), ref.fwt_ref(rows))
    assert (FWT.KERNEL.launches, FWT.COLUMNS_KERNEL.launches) == (n0 + 2, c0 + 1)
    with pytest.raises(ValueError, match="shared memory"):
        FWT.fwt_block(torch.zeros((1, 1 << 16), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        FWT.fwt_columns(torch.zeros((1 << 16, 1), device=cuda))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("b", [1, 8, 16, 32, 64, 256, 1024])
def test_nw_tile_kernel_matches_plain(cuda, b, integer):
    rng = np.random.default_rng(b)
    if integer:
        north, west = (rng.integers(-b, b, b).astype(np.float32) for _ in range(2))
        sub, corner, gap = rng.choice([-1.0, 1.0], size=(b, b)).astype(np.float32), -2.0, 1.0
    else:
        north, west = (rng.normal(size=b).astype(np.float32) for _ in range(2))
        sub, corner, gap = rng.normal(size=(b, b)).astype(np.float32), 0.3, 0.5
    args = [torch.from_numpy(a) for a in (north, west)]
    n0 = NW.KERNEL.launches
    got = ops.nw_tile(args[0].to(cuda), args[1].to(cuda), corner,
                      torch.from_numpy(sub).to(cuda), gap=gap)
    torch.cuda.synchronize()
    assert NW.KERNEL.launches == n0 + 1
    want = ops.nw_tile(args[0], args[1], corner, torch.from_numpy(sub), gap=gap)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if integer and b <= 64:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      ref.nw_ref(north, west, corner, sub, gap=gap))


@pytest.mark.parametrize("n,m,block", [(512, 384, 32), (256, 256, 64), (128, 96, 8),
                                       (64, 64, 16)], ids=str)
def test_nw_wavefront_on_card_bit_equal(cuda, n, m, block):
    rng = np.random.default_rng(n + m)
    a, b = rng.integers(0, 4, n), rng.integers(0, 4, m)
    scores = np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32)
    n0 = NW.KERNEL.launches
    got = ops.nw_wavefront(torch.from_numpy(scores).to(cuda), block=block).cpu().numpy()
    assert NW.KERNEL.launches - n0 == 1  # one launch walks the whole tile grid
    np.testing.assert_array_equal(got, ref.nw_full_ref(scores))
    plain = NW.nw_wavefront_plain(torch.from_numpy(scores).to(cuda), block=block)
    np.testing.assert_array_equal(got, plain.cpu().numpy())


def _nw_scores(n, m, seed, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        a, b = rng.integers(0, 4, n), rng.integers(0, 4, m)
        return np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32)
    return rng.normal(size=(n, m)).astype(np.float32)


@pytest.mark.parametrize("n,m,block,integer", [(64, 8192, 1, True), (32, 16384, 2, False)],
                         ids=str)
def test_nw_wavefront_more_strips_than_blocks(cuda, n, m, block, integer):
    """A wide grid: more strips (tile columns) than the card holds blocks
    of B threads (at most 32 a SM), so blocks take several strips from the
    ticket; bit-equal to the plain version."""
    scores = _nw_scores(n, m, n + m + block, integer)
    plan = NW.plan_strips(n // block, m // block, 0, n // block + m // block - 1)
    assert plan.n_strips > 32 * torch.cuda.get_device_properties(cuda).multi_processor_count
    gap = 1.0 if integer else 0.5
    got = ops.nw_wavefront(torch.from_numpy(scores).to(cuda), block=block, gap=gap)
    want = NW.nw_wavefront_plain(torch.from_numpy(scores), block=block, gap=gap)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if integer:
        np.testing.assert_array_equal(got.cpu().numpy(), ref.nw_full_ref(scores))


def test_nw_wavefront_four_tasks_on_four_streams(cuda):
    """Four 2048^2 tasks launched on four streams at once (the streaming
    path's overlap): each bit-equal to the plain version."""
    tasks = [torch.from_numpy(_nw_scores(2048, 2048, 50 + k)).to(cuda) for k in range(4)]
    side = [torch.cuda.Stream(cuda) for _ in tasks]
    torch.cuda.synchronize()
    n0 = NW.KERNEL.launches
    outs = []
    for st, t in zip(side, tasks):
        with torch.cuda.stream(st):
            outs.append(ops.nw_wavefront(t, block=32))
    torch.cuda.synchronize()
    assert NW.KERNEL.launches - n0 == 4
    for t, got in zip(tasks, outs):
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      NW.nw_wavefront_plain(t, block=32).cpu().numpy())


@pytest.mark.parametrize("integer", [True, False])
def test_nw_diagonal_and_run_on_card_over_partial_runs(cuda, integer):
    """nw_diagonal over each diagonal cut into two runs of its tiles, and
    nw_run over [0, 5), [5, 17) and the rest: bit-equal to the plain
    version, one launch a call."""
    n, m, block = 256, 384, 32
    scores = torch.from_numpy(_nw_scores(n, m, 7, integer))
    gap = 1.0 if integer else 0.5
    want = NW.nw_wavefront_plain(scores, block=block, gap=gap).numpy()
    rows, cols = n // block, m // block
    state, sc, out = NW.initial_state(scores.to(cuda), block, gap=gap)
    n0 = NW.KERNEL.launches
    for diag in [d for d in wavefront.diagonal_tiles(rows, cols)]:
        half = (len(diag) + 1) // 2
        for run in (diag[:half], diag[half:]):
            if run:
                NW.nw_diagonal(state, sc, run, gap=gap)
    calls = sum(1 + (len(d) > 1) for d in wavefront.diagonal_tiles(rows, cols))
    assert NW.KERNEL.launches - n0 == calls
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    state, sc, out = NW.initial_state(scores.to(cuda), block, gap=gap)
    n0 = NW.KERNEL.launches
    for d0, d1 in ((0, 5), (5, 17), (17, rows + cols - 1)):
        NW.nw_run(state, sc, d0, d1, gap=gap)
    assert NW.KERNEL.launches - n0 == 3
    np.testing.assert_array_equal(out.cpu().numpy(), want)


def test_paper_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    x = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(x.t()[:, :4], x[:4])
    with pytest.raises(ValueError):
        ops.matmul(x.double(), x)
    with pytest.raises(ValueError, match="contiguous"):
        FWT.fwt_block(torch.zeros((8, 16), device=cuda).t())
    with pytest.raises(ValueError, match="aligned"):
        FWT.fwt_block(torch.zeros(33, device=cuda)[1:].reshape(2, 16))
    with pytest.raises(ValueError, match="contiguous"):
        FWT.fwt_columns(torch.zeros((16, 8), device=cuda).t())
    with pytest.raises(ValueError, match="does not match"):
        FWT.fwt_columns(x, out=torch.zeros((8, 8), device=cuda).bfloat16())
    with pytest.raises(ValueError, match="device"):
        ops.matmul(x, x.cpu())


def _executor_tasks(n_tasks, size, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.standard_normal((size, size), np.float32)).pin_memory()
                  for _ in range(2)) for _ in range(n_tasks)]


def test_executor_on_card_multi_equals_single_and_overlaps(cuda):
    """Matmul tasks over 4 CUDA streams: multi-stream outputs bit-equal to
    stage-by-stage outputs and to the kernel run directly, and the events
    show one task's H2D running beside another task's KEX."""
    tasks = _executor_tasks(8, 1024)
    ex = streams.HostStreamExecutor(lambda t: ops.matmul(t[0], t[1]), num_streams=4,
                                    device=cuda)
    assert all(s != torch.cuda.default_stream(cuda) for s in ex.streams)
    ex.single_stream_run(tasks)  # warm-up
    out1, s1 = ex.single_stream_run(tasks)
    outn, sn = ex.multi_stream_run(tasks)
    for a, b, (x, y) in zip(out1, outn, tasks):
        assert a.is_pinned() and b.is_pinned()
        assert torch.equal(a, b)
        assert torch.equal(a, ops.matmul(x.to(cuda), y.to(cuda)).cpu())
    assert s1.h2d > 0 and s1.kex > 0 and s1.d2h > 0 and 0.0 < ex.measure_r(tasks)[0] < 1.0
    assert len(sn.intervals) == 8 and {iv["stream"] for iv in sn.intervals} == {0, 1, 2, 3}
    assert sn.h2d_kex_overlap() > 0.0, sn.intervals


def test_executor_on_card_refuses_emulation_and_pageable_tasks(cuda):
    with pytest.raises(ValueError, match="link"):
        streams.HostStreamExecutor(lambda x: x, device=cuda, link_bw=2e9)
    ex = streams.HostStreamExecutor(lambda x: x * 2, num_streams=2, device=cuda)
    with pytest.raises(ValueError, match="pinned"):
        ex.multi_stream_run([torch.ones(4)])


# -- compiled ticks: each graphed step against the eager step ------------------------


def _full_width(arch):
    """The arch's published widths cut to 2 layers, f32."""
    return dataclasses.replace(configs.get_config(arch), n_layers=2,
                               param_dtype=torch.float32, compute_dtype=torch.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _state(eng):
    """Every tensor a step of ``eng`` updates in place."""
    return _leaves(eng.kv.pools if eng.paged else eng.caches) + _leaves(
        eng.servable.single.request_cache())


def _graph_vs_eager(step, vals, state, **override):
    """Run ``step`` from one saved state at its first use (eager) and at its
    second (capture, then replay); with ``override``, a third run (a replay
    with those inputs changed) against the step function run eagerly on the
    same static inputs.  Returns [(outputs, state after)] per run, the
    eager twin last, with the state restored."""
    saved = [t.clone() for t in state]

    def run(fn):
        for t, s in zip(state, saved):
            t.copy_(s)
        out = fn()
        torch.cuda.synchronize()
        return [t.clone() for t in _leaves(out)] if out is not None else [], \
            [t.clone() for t in state]

    runs = [run(lambda: step(**vals)), run(lambda: step(**vals))]
    assert step.graph is not None and step.uses == 2
    if override:
        runs.append(run(lambda: step(**{**vals, **override})))
        runs.append(run(lambda: step.fn(**step.inputs)))
    for t, s in zip(state, saved):
        t.copy_(s)
    return runs


def _same(a, b) -> bool:
    """Outputs and states of two runs agree (f32 within 1e-5, integers
    exactly); True when they are bit-equal."""
    bit = True
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        if x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(x, y)
        bit = bit and torch.equal(x, y)
    return bit


def _counted(step, vals, n=3):
    """Launch counts of ``n`` replays of ``step``, per kernel."""
    before = {k: k.launches for k in _build.KERNELS}
    for _ in range(n):
        step(**vals)
    torch.cuda.synchronize()
    return {k: k.launches - before[k] for k in _build.KERNELS if k.launches != before[k]}


def _warm_engine(cfg, cuda, n_steps, **kw):
    params = T.init_params(cfg, 0, device=cuda)
    scfg = serving.ServeConfig(max_seq=128, prefill_chunk=32, max_new_tokens=32, max_batch=4,
                               block_size=16, **kw)
    eng = serving.StreamedBatchEngine(cfg, params, scfg, device=cuda)
    rng = np.random.default_rng(11)
    for n in (40, 33, 64, 20):
        enc = None
        if cfg.is_encoder_decoder:  # whisper: each request's encoder frames
            enc = (0.1 * rng.standard_normal((cfg.encoder_seq, cfg.d_model))).astype(np.float32)
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), enc_inputs=enc)
    for _ in range(n_steps):
        eng.step()
    assert len(eng.active_slots) == 4
    return eng


def _tick_vals(eng, t):
    b = eng.scfg.max_batch
    toks, cur = np.zeros((b, t), np.int32), np.zeros((b,), np.int32)
    for s in eng.active_slots:
        toks[s.index, 0], cur[s.index] = s.pending, s.cur
        if eng.paged:
            for pos in range(s.cur, s.cur + t):
                assert eng.kv.ensure_write(s.index, pos)
    return eng._tick_inputs(eng.active_slots, toks, cur)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_graphed_qwen_steps_equal_eager_steps(cuda, kv_dtype):
    """2-layer full-width qwen3-4b, f32, paged: the decode tick, the verify
    tick, a fused prefill chunk and the three page moves, each captured and
    replayed, equal their eager first run (outputs and every pool leaf); a
    replay after the host page table changed reads the new table; N
    replays launch N x the captured counts."""
    from repro_torch.runtime.graphs import StepGraph
    cfg = _full_width("qwen3-4b")
    eng = _warm_engine(cfg, cuda, 3, paged=True, kv_dtype=kv_dtype, spec_decode=True,
                       spec_k=3)
    state = _state(eng)
    q = "QUANT_" if kv_dtype != "fp32" else ""
    bits = {}

    step = eng._tick_graph(eng.servable.decode_fn(paged=True), t=1)
    vals = _tick_vals(eng, 1)
    # Rows 0 and 1 trade their table rows (and their tokens and positions):
    # a replay that reads the new table trades their picks and writes the
    # same pages.  (Two rows mapping one page would race: which quantized
    # write lands is unspecified.)
    perm = [1, 0, 2, 3]
    runs = _graph_vs_eager(step, vals, state, **{k: vals[k][perm]
                                                 for k in ("page_table", "toks", "cur")})
    bits["decode"] = _same(runs[0], runs[1])
    bits["decode, new table"] = _same(runs[2], runs[3])
    assert torch.equal(runs[2][0][0], runs[1][0][0][perm])
    _same((runs[2][1], []), (runs[1][1], []))
    assert step.launches == {getattr(PA, f"{q}KERNEL"): cfg.n_layers}
    assert _counted(step, vals) == {getattr(PA, f"{q}KERNEL"): 3 * cfg.n_layers}

    step = eng._tick_graph(eng.servable.verify_fn(paged=True), t=4, verify=True)
    vals = dict(_tick_vals(eng, 4), d_len=np.array([3, 0, 2, 3], np.int32))
    vals["toks"][:, 1:] = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 3))
    runs = _graph_vs_eager(step, vals, state)
    bits["verify"] = _same(runs[0], runs[1])
    assert step.launches == {getattr(PA, f"MULTI_{q}KERNEL"): cfg.n_layers}
    assert _counted(step, vals) == {getattr(PA, f"MULTI_{q}KERNEL"): 3 * cfg.n_layers}

    eng.servable.single._chunk_jit.clear()
    step = eng.servable.single._fused_chunk_fn(32, 32, eng.kv.pools)
    pages = eng.kv.slot_pages(eng.active_slots[0].index)[:4]
    vals = dict(tokens=np.arange(32, dtype=np.int32)[None] * 7,
                page_table=np.asarray(pages, np.int32)[None])
    runs = _graph_vs_eager(step, vals, state)
    bits["fused chunk"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {FA.KERNEL: 3 * cfg.n_layers}

    kv, slot = eng.kv, eng.active_slots[1].index
    own = kv.slot_pages(slot)
    for name, make, vals in (
            ("scatter", kv._make_scatter(2), dict(pages=own[:2], rows=np.arange(16, 48),
                                                   slot=slot)),
            ("gather", kv._make_gather(3), dict(pages=own[:3])),
            ("load", kv._make_load(2), dict(pages=own[1:3]))):
        assert isinstance(make, StepGraph)
        runs = _graph_vs_eager(make, vals, state)
        bits[name] = _same(runs[0], runs[1])
        assert _counted(make, vals) == {}
    print(f"graph replay bit-equal to the eager step ({kv_dtype}): {bits}")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_graphed_mamba_steps_equal_eager_steps(cuda, paged):
    """2-layer full-width mamba2-2.7b, f32: the mamba step (state written in
    place) and a b=1 streamed chunk over the request cache, captured and
    replayed, equal their eager first run; the chunk's replays launch the
    SSD kernel once a layer, the step none.  Paged: the scatter graph; a
    pure mamba pool has no paged leaf, so its gather has no graph and
    copies the slot's state rows."""
    cfg = _full_width("mamba2-2.7b")
    eng = _warm_engine(cfg, cuda, 3, paged=paged)
    state = _state(eng)
    bits = {}
    step = eng._tick_graph(eng.servable.decode_fn(paged=paged), t=1)
    vals = _tick_vals(eng, 1)
    runs = _graph_vs_eager(step, vals, state)
    bits["step"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {}
    single = eng.servable.single
    single._chunk_jit.clear()
    step = single._prefill_chunk_fn(32, False, 32)
    vals = dict(tokens=np.arange(32, dtype=np.int32)[None] * 5)
    runs = _graph_vs_eager(step, vals, state)
    bits["chunk"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {SSD.KERNEL: 3 * cfg.n_layers}
    if paged:
        slot = eng.active_slots[0].index
        runs = _graph_vs_eager(eng.kv._make_scatter(1), dict(
            pages=eng.kv.slot_pages(slot)[:1], rows=np.arange(16), slot=slot), state)
        bits["scatter"] = _same(runs[0], runs[1])
        assert eng.kv._make_gather(1) is None
        got = eng.kv.gather(slot, 16)["blocks"]["layer0"]
        for key, leaf in eng.kv.pools["blocks"]["layer0"].items():
            assert torch.equal(got[key], leaf[:, slot: slot + 1])
    print(f"graph replay bit-equal to the eager step (mamba, paged={paged}): {bits}")


def test_graphed_moe_steps_equal_eager_steps(cuda):
    """2-layer full-width qwen2-moe-a2.7b, f32, paged: the decode tick (4
    slots: capacity 1 an expert, so choices drop), the verify tick and a
    fused prefill chunk, captured and replayed, equal their eager first run
    (outputs and every pool leaf); the MoE step adds no launch of a port
    kernel."""
    cfg = _full_width("qwen2-moe-a2.7b")
    eng = _warm_engine(cfg, cuda, 3, paged=True, spec_decode=True, spec_k=3)
    state = _state(eng)
    bits = {}
    step = eng._tick_graph(eng.servable.decode_fn(paged=True), t=1)
    vals = _tick_vals(eng, 1)
    runs = _graph_vs_eager(step, vals, state)
    bits["decode"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {PA.KERNEL: 3 * cfg.n_layers}
    step = eng._tick_graph(eng.servable.verify_fn(paged=True), t=4, verify=True)
    vals = dict(_tick_vals(eng, 4), d_len=np.array([3, 0, 2, 3], np.int32))
    vals["toks"][:, 1:] = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 3))
    runs = _graph_vs_eager(step, vals, state)
    bits["verify"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {PA.MULTI_KERNEL: 3 * cfg.n_layers}
    eng.servable.single._chunk_jit.clear()
    step = eng.servable.single._fused_chunk_fn(32, 32, eng.kv.pools)
    pages = eng.kv.slot_pages(eng.active_slots[0].index)[:4]
    vals = dict(tokens=np.arange(32, dtype=np.int32)[None] * 7,
                page_table=np.asarray(pages, np.int32)[None])
    runs = _graph_vs_eager(step, vals, state)
    bits["fused chunk"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {FA.KERNEL: 3 * cfg.n_layers}
    print(f"graph replay bit-equal to the eager step (qwen2-moe): {bits}")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_graphed_whisper_steps_equal_eager_steps(cuda, paged):
    """whisper-medium at published widths, 2 decoder and 2 encoder layers,
    1500 frames, f32: the decode tick (cross-attention over the slots'
    stored K/V, torch ops) and a first chunk (its encoder output a static
    input, the cross K/V stored into the request cache), captured and
    replayed, equal their eager first run; the tick launches the paged
    kernel once a layer (none contiguous), the chunk the prefill kernel
    twice a layer (self- and cross-attention)."""
    cfg = dataclasses.replace(_full_width("whisper-medium"), n_encoder_layers=2)
    eng = _warm_engine(cfg, cuda, 3, paged=paged)
    state = _state(eng)
    bits = {}
    step = eng._tick_graph(eng.servable.decode_fn(paged=paged), t=1)
    vals = _tick_vals(eng, 1)
    runs = _graph_vs_eager(step, vals, state)
    bits["tick"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == ({PA.KERNEL: 3 * cfg.n_layers} if paged else {})
    single = eng.servable.single
    single._chunk_jit.clear()
    step = single._prefill_chunk_fn(32, True, 0)
    enc = single.encode(torch.randn((1, cfg.encoder_seq, cfg.d_model)) * 0.1)
    vals = dict(tokens=np.arange(32, dtype=np.int32)[None] * 5, enc_out=enc)
    runs = _graph_vs_eager(step, vals, state)
    bits["first chunk"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {FA.KERNEL: 3 * 2 * cfg.n_layers}
    cross = single.request_cache()["blocks"]["layer0"]["cross_k"]
    assert cross.abs().sum().item() > 0
    print(f"graph replay bit-equal to the eager step (whisper, paged={paged}): {bits}")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_graphed_jamba_steps_equal_eager_steps(cuda, paged):
    """jamba-1.5-large at published widths, unit positions 0 and 3 (mamba +
    dense FFN, attention + MoE), 4 experts, f32: the decode tick and a b=1
    chunk, captured and replayed, equal their eager first run; the tick
    launches the paged kernel once (none contiguous), the chunk the SSD
    and the prefill kernels once each."""
    full = configs.get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, layer_unit=(full.layer_unit[0], full.layer_unit[3]),
                              n_layers=2, n_experts=4, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    eng = _warm_engine(cfg, cuda, 3, paged=paged)
    state = _state(eng)
    bits = {}
    step = eng._tick_graph(eng.servable.decode_fn(paged=paged), t=1)
    vals = _tick_vals(eng, 1)
    runs = _graph_vs_eager(step, vals, state)
    bits["tick"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == ({PA.KERNEL: 3} if paged else {})
    single = eng.servable.single
    single._chunk_jit.clear()
    step = single._prefill_chunk_fn(32, False, 32)
    vals = dict(tokens=np.arange(32, dtype=np.int32)[None] * 5)
    runs = _graph_vs_eager(step, vals, state)
    bits["chunk"] = _same(runs[0], runs[1])
    assert _counted(step, vals) == {SSD.KERNEL: 3, FA.KERNEL: 3}
    print(f"graph replay bit-equal to the eager step (jamba, paged={paged}): {bits}")


def test_engine_graphs_free_with_the_engine(cuda):
    """A graphed serve's pool goes with its engine: reserved memory after a
    second engine's serve is what it was after the first's."""
    import gc
    cfg = _full_width("qwen3-4b")
    reserved = []
    for _ in range(3):
        eng = _warm_engine(cfg, cuda, 3, paged=True)
        eng.run()
        assert eng.graphs.captured > 0 and eng.graphs.replays > 0
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[2] <= reserved[1], reserved


@pytest.mark.parametrize("arch,paged", [("qwen3-4b", True), ("qwen3-4b", False),
                                        ("mamba2-2.7b", True)],
                         ids=["qwen paged", "qwen contiguous", "mamba paged"])
def test_stage_probe_leaves_live_state_alone_on_card(cuda, arch, paged):
    """``measure_stage_times`` with 4 slots active mid decode (2-layer
    full-width f32, graphed): every pool or slot-cache leaf and the page
    table as they were, and the serve's tokens those of a serve never
    probed."""
    cfg = _full_width(arch)
    want = _warm_engine(cfg, cuda, 3, paged=paged).run()
    eng = _warm_engine(cfg, cuda, 3, paged=paged)
    before = [t.clone() for t in _leaves(eng.kv.pools if paged else eng.caches)]
    table = eng.kv.page_table.copy() if paged else None
    st = eng.measure_stage_times(64)
    torch.cuda.synchronize()
    assert st.h2d > 0 and st.kex > 0
    after = _leaves(eng.kv.pools if paged else eng.caches)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    if paged:
        np.testing.assert_array_equal(eng.kv.page_table, table)
    got = eng.run()
    assert got.keys() == want.keys()
    for u in want:
        np.testing.assert_array_equal(got[u], want[u])
    print(f"stage probe ({arch}, paged={paged}): chunk {st.h2d * 1e3:.3f} ms, "
          f"tick {st.kex * 1e3:.3f} ms, live state unchanged")


def test_autotune_rebuild_on_card(cuda):
    """A page-size change on the idle pool (2-layer full-width f32 qwen3,
    graphed): the graphs captured over the old pool never replay again nor
    stay held, new ones are captured over the new pool, and the tokens
    equal a fresh engine's at the planned page size."""
    from repro_torch.core import rmetric
    cfg = _full_width("qwen3-4b")
    eng = _warm_engine(cfg, cuda, 3, paged=True)
    first = eng.run()
    old = [eng._decode] + [g for k, g in eng.servable.single._chunk_jit.items()
                           if k[0] == "fused"]
    old += [g for c in (eng.kv._scatter_jit, eng.kv._gather_jit, eng.kv._load_jit)
            for g in c.values() if g is not None]
    uses = [g.uses for g in old]
    captured = eng.graphs.captured
    eng.measure_stage_times = lambda n: rmetric.StageTimes(h2d=0.004, kex=0.002)
    plan = eng.autotune(64)
    assert plan.block_size == eng.kv.block_size == 8
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 33, 64, 20)]
    uids = [eng.submit(p) for p in prompts]
    second = eng.run()
    assert [g.uses for g in old] == uses
    held = [eng._decode] + list(eng.servable.single._chunk_jit.values())
    assert not any(g is h for g in old for h in held)
    assert eng.graphs.captured > captured and eng._decode.graph is not None
    fresh = serving.StreamedBatchEngine(cfg, eng.params, dataclasses.replace(
        eng.scfg, arch_kind=None), device=cuda)
    for p in prompts:
        fresh.submit(p)
    want = fresh.run()
    for u, w in zip(uids, sorted(want)):
        np.testing.assert_array_equal(second[u], want[w])
    assert sorted(first) == list(range(4))
    print(f"autotune rebuild: block 16 -> 8, graphs captured {captured} -> "
          f"{eng.graphs.captured}; tokens equal to a fresh engine at block 8")


# -- the stream-safety analyzer on the card ---------------------------------------------


def test_quant_contract_runs_through_the_quant_kernels(cuda):
    """KRN003 on the card: each quantized entry launches its kernel (int8
    and fp8) and the contract holds."""
    from repro_torch.analysis import kernelcheck

    before = (PA.QUANT_KERNEL.launches, PA.MULTI_QUANT_KERNEL.launches)
    assert kernelcheck.check_quant_contract(cuda) == []
    torch.cuda.synchronize()
    assert PA.QUANT_KERNEL.launches == before[0] + 2
    assert PA.MULTI_QUANT_KERNEL.launches == before[1] + 2


def test_live_audit_passes_a_clean_tick_and_raises_on_a_planted_item(cuda):
    """The live sync audit on a paged smoke engine: a clean serve (cold
    ticks, captures, warm replays) has no finding and each tick fetches
    once; an ``.item()`` planted in the tick raises under the audit and is
    recorded as STR001 at the tick."""
    from repro_torch.analysis import synccheck

    findings, rep = synccheck.live_engine("transformer", "paged", device=cuda)
    assert findings == [], findings
    assert rep["max_fetches"]["StreamedBatchEngine._plain_tick"] == 1
    assert rep["sanctioned"].get("capture", 0) > 0 and rep["preemptions"] >= 1

    eng = synccheck.build_engine("transformer", "paged", device=cuda)
    rng = np.random.default_rng(3)
    for n in (30, 20):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32))
    eng.run()  # warm: every step of the second serve replays
    tick = eng._plain_tick

    def planted():
        eng.decode_steps += int(torch.ones(1, device=cuda).sum().item()) - 1
        return tick()

    eng._plain_tick = planted
    eng.submit(rng.integers(0, eng.cfg.vocab_size, 30).astype(np.int32))
    audit = synccheck.LiveAudit(cuda).watch(eng)
    with audit, pytest.raises(RuntimeError, match="synchronizing CUDA operation"):
        eng.run()
    assert [(f.rule, f.target) for f in audit.findings] == [
        ("STR001", "live:StreamedBatchEngine._plain_tick")]
    assert torch.cuda.get_sync_debug_mode() == 0  # the audit leaves the mode off
