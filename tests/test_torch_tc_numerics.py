"""The arithmetic of the two tensor-core kernels, on the CPU, against the
JAX package: the prefill body (``csrc/flash_attention.cu``, bf16 products,
P rounded to bf16 per 16-key tile, key splits combined at the end) through
its plain emulation ``ref.flash_attention_tc_plain``, and the 3xTF32 matmul
(``csrc/streamed_matmul.cu``) through ``ref.matmul_tf32_plain`` and its
TF32 rounding ``ref.tf32_round``; with them the wrappers' plans
(``flash_attention.plan_flash``, ``streamed_matmul.plan_matmul``).  The
kernels themselves run only on a card: ``tests/test_torch_cuda.py``.

Tolerances.  Prefill, bf16 outputs: one bf16 ulp at the reference
output's largest magnitude (2^(floor(log2 max|want|) - 7)), and with one
key split at least 99% of the outputs bit-equal to the reference at chunk
16 (the same P rounding at the same tiles; only f32 sums in another order
differ), where the f32-P plain version meets fewer than 90%.  With 2 or 4
key splits each split rounds P against its own running max, so two ulps.
Matmul, max abs error relative to the reference output's largest
magnitude (at least 1): 1e-5, ``PAPER_RTOL[f32]`` of the card tests, which
three TF32 products meet and one misses (it keeps ~11 bits of each
operand)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.models import attention as rattn
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import streamed_matmul as MM

BF16 = torch.bfloat16
EQUAL_SHARE = 0.99  # outputs bit-equal to the reference, one key split
PLAIN_EQUAL_SHARE = 0.9  # the f32-P plain version stays below it
MM_RTOL = 1e-5


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _bf16_case(seed, *, sq, q_offset, g, hd=32, hkv=2, b=2):
    """bf16 q (B, Sq, H, hd), k/v (B, q_offset + Sq, Hkv, hd) from numpy,
    and the same values as JAX arrays."""
    rng = np.random.default_rng(seed)
    sk = q_offset + sq
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hkv * g, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]
    ts = [torch.from_numpy(a).to(BF16) for a in arrs]
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]
    return ts, js


def _as_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


# Ragged Sq, q_offset > 0, window, softcap, g 1 and 4 (Sk a multiple of 16,
# so that the reference's key chunk is 16 too).
FLASH_CASES = [
    dict(sq=37, q_offset=27, g=1),
    dict(sq=37, q_offset=27, g=4, window=20),
    dict(sq=48, q_offset=16, g=4, softcap=5.0),
    dict(sq=64, q_offset=64, g=4, hd=64),
    dict(sq=13, q_offset=35, g=4, window=9, softcap=10.0),
    dict(sq=20, q_offset=300, g=1, hd=64, window=100),
]


def _kw(case):
    return dict(window=case.get("window", 0), softcap=case.get("softcap", 0.0))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_tc_emulation_matches_flash_attention_ref(case):
    (q, k, v), (qj, kj, vj) = _bf16_case(
        1, sq=case["sq"], q_offset=case["q_offset"], g=case["g"], hd=case.get("hd", 32))
    kw = _kw(case)
    want = _as_torch(rattn.flash_attention_ref(
        qj, kj, vj, chunk=FA.KEY_TILE, q_offset=case["q_offset"], window=kw["window"],
        softcap_val=kw["softcap"]))
    ulp = _ulp(want.abs().max().item())
    got = ref.flash_attention_tc_plain(q, k, v, q_offset=case["q_offset"],
                                       key_tile=FA.KEY_TILE, **kw).float()
    assert (got - want).abs().max().item() <= ulp
    assert (got == want).float().mean().item() >= EQUAL_SHARE
    plain = FA.flash_attention_plain(q, k, v, scale=1 / math.sqrt(q.shape[-1]),
                                     q_offset=case["q_offset"], **kw).float()
    assert (plain == want).float().mean().item() < PLAIN_EQUAL_SHARE
    for splits in (2, 4):
        got = ref.flash_attention_tc_plain(q, k, v, q_offset=case["q_offset"],
                                           key_tile=FA.KEY_TILE, key_splits=splits, **kw)
        assert (got.float() - want).abs().max().item() <= 2 * ulp
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("kw", [dict(), dict(window=7), dict(softcap=20.0)], ids=str)
@pytest.mark.parametrize("g", [1, 4])
def test_flash_tc_emulation_matches_pallas_kernel(kw, g):
    """Block-divisible shapes, q_offset 0: the Pallas kernel in interpret
    mode with key blocks of the emulation's tile."""
    (q, k, v), (qj, kj, vj) = _bf16_case(2, sq=48, q_offset=0, g=g)
    want = _as_torch(rops.flash_attention(qj, kj, vj, block_q=16, block_k=FA.KEY_TILE,
                                          interpret=True, **kw))
    got = ref.flash_attention_tc_plain(q, k, v, key_tile=FA.KEY_TILE, **kw).float()
    assert (got - want).abs().max().item() <= _ulp(want.abs().max().item())
    assert (got == want).float().mean().item() >= EQUAL_SHARE


@pytest.mark.parametrize("case", FLASH_CASES[:4], ids=str)
def test_flash_tc_emulation_with_f32_inputs_is_the_plain_version(case):
    """With inputs exact in bf16 but carried in f32, only P's rounding
    separates the emulation from the plain version: at most ~2^-9 of the
    output's magnitude."""
    (q, k, v), _ = _bf16_case(3, sq=case["sq"], q_offset=case["q_offset"], g=case["g"],
                              hd=case.get("hd", 32))
    q, k, v = q.float(), k.float(), v.float()
    got = ref.flash_attention_tc_plain(q, k, v, q_offset=case["q_offset"], **_kw(case))
    want = FA.flash_attention_plain(q, k, v, scale=1 / math.sqrt(q.shape[-1]),
                                    q_offset=case["q_offset"], **_kw(case))
    assert (got - want).abs().max().item() <= 2.0 ** -8 * want.abs().max().item()


# -- the plans ---------------------------------------------------------------------


def test_plan_flash_serve_and_long_context_shapes():
    """The serve's chunk (B 1, Sq 64, H 32 / 8, hd 128): 128 m-tiles of 16
    rows, one a block, its four warps splitting the keys: 128 blocks of 4
    warps; the long context has the same rows and the same plan."""
    plan = FA.plan_flash(1, 64, 32, 8, 128, BF16)
    assert plan == FA.FlashPlan("tc", (16, 8, 1), 4, 4, 16)
    assert plan.blocks == 128 and plan.blocks * plan.warps == 512


@pytest.mark.parametrize("shape,grid", [
    ((1, 512, 32, 8, 128), (128, 8, 1)),  # a longer chunk: 1024 m-tiles
    ((1, 160, 32, 8, 128), (40, 8, 1)),
    ((2, 37, 8, 8, 64), (3, 8, 2)),       # g 1, ragged
    ((1, 13, 64, 8, 256), (7, 8, 1)),     # g 8, head_dim 256
])
def test_plan_flash_tiles(shape, grid):
    """One m-tile a block whatever the shape, its warps splitting the keys."""
    plan = FA.plan_flash(*shape, BF16)
    assert plan == FA.FlashPlan("tc", grid, FA.TC_WARPS, FA.TC_WARPS, FA.KEY_TILE)


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128), (BF16, 24), (torch.float32, 24)])
def test_plan_flash_simt_body(dtype, hd):
    """f32, or a head_dim that is not a multiple of 16, keeps the SIMT body:
    one query head a block, no key split."""
    plan = FA.plan_flash(2, 37, 32, 8, hd, dtype)
    assert plan == FA.FlashPlan("simt", (64, 3, 1), 4, 1, 32)


@pytest.mark.parametrize("mkn,dtypes,want", [
    ((2048, 2048, 2048), ("float32", "float32"), ("tf32", 3, (16, 16))),
    ((2047, 33, 2049), ("float32", "float32"), ("tf32", 3, (17, 16))),
    ((2049, 32, 2047), ("float32", "float32"), ("tf32", 3, (16, 17))),
    ((256, 256, 256), ("float32", "bfloat16"), ("tf32", 2, (2, 2))),
    ((256, 256, 256), ("bfloat16", "float32"), ("tf32", 2, (2, 2))),
    ((256, 256, 256), ("bfloat16", "bfloat16"), ("bf16", 1, (2, 2))),
    ((129, 257, 130), ("bfloat16", "bfloat16"), ("bf16", 1, (2, 2))),
    ((1, 1000, 1), ("float32", "float32"), ("tf32", 3, (1, 1))),
])
def test_plan_matmul(mkn, dtypes, want):
    m, k, n = mkn
    plan = MM.plan_matmul(m, n, k, *(getattr(torch, d) for d in dtypes))
    assert (plan.body, plan.products, plan.grid) == want


def test_wrappers_on_cpu_run_the_plain_versions():
    """A CPU tensor never reaches the kernels: the plain versions answer and
    no launch is counted."""
    (q, k, v), _ = _bf16_case(4, sq=16, q_offset=16, g=4)
    n_fa, n_mm = FA.KERNEL.launches, MM.KERNEL.launches
    out = ops.flash_attention(q, k, v, q_offset=16)
    assert torch.equal(out, FA.flash_attention_plain(q, k, v, scale=1 / math.sqrt(32),
                                                     q_offset=16))
    x = torch.randn(8, 5)
    assert torch.equal(ops.matmul(x, x.t().contiguous()), MM.matmul_plain(x, x.t()))
    assert (FA.KERNEL.launches, MM.KERNEL.launches) == (n_fa, n_mm)


# -- the matmul's TF32 products ----------------------------------------------------


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 0.75 * ulp, 2.0**100 * (1 + ulp / 2), float("inf"), -0.0, 1e-40])
    want = torch.tensor([1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 1 + ulp,
                         2.0**100 * (1 + ulp), float("inf"), -0.0, 1.0331493e-40])
    got = ref.tf32_round(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.isnan(ref.tf32_round(torch.tensor([float("nan")]))).all()
    r = torch.randn(10_000)
    assert ((r - ref.tf32_round(r)).abs() <= r.abs() * 2.0 ** -11).all()


def _mm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("mkn", [(256, 256, 256), (512, 384, 640)], ids=str)
def test_3xtf32_meets_f32_tolerance_and_one_tf32_product_misses(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    want = rops.matmul(jnp.asarray(x), jnp.asarray(y), block_m=128, block_n=128,
                       block_k=128, interpret=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert _mm_err(ref.matmul_tf32_plain(xt, yt), want) <= MM_RTOL
    assert _mm_err(ref.matmul_tf32_plain(xt, yt, products=1), want) > MM_RTOL


@pytest.mark.parametrize("bf16_side", ["x", "y"])
def test_mixed_types_need_two_tf32_products(bf16_side):
    """A bf16 operand is exact in TF32: its small part is 0, and the two
    products left meet the f32 tolerance."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    if bf16_side == "x":
        x = x.to(BF16)
    else:
        y = y.to(BF16)
    b = x if bf16_side == "x" else y
    assert torch.equal(ref.tf32_round(b.float()), b.float())
    want = rops.matmul(*(jnp.asarray(t.float().numpy()) for t in (x, y)), block_m=128,
                       block_n=128, block_k=128, interpret=True)
    got = ref.matmul_tf32_plain(x, y)
    assert got.dtype == torch.float32
    assert _mm_err(got, want) <= MM_RTOL
