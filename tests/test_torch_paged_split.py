"""What surrounds the split body of the paged-attention kernel, on the CPU:
the plain emulation of its split-and-combine arithmetic
(``ref.paged_attention_multi_split_plain``) against the port's plain
versions and the JAX package's Pallas kernels (interpret mode), for draft
blocks and single-token calls (q_len 1), including splits that every row
masks; the wrapper's split planner and its choice of body; and the
precision of P over code pools.  The kernel itself runs only on a card:
``tests/test_torch_cuda.py``.

Tolerances, max abs error relative to the expected output's largest
magnitude (at least 1): split emulation vs ``paged_attention_multi_ref``
over every split size and behind the window, both in f64, 1e-6 (the same sums regrouped by
split); vs the JAX package, in f32, 2e-5, as ``tests/test_torch_kernels.py``
(sums in another order).  Relative to the magnitude because a shielded row
attends only trash keys, whose garbage here is 100 times the data: its
output is in the hundreds.

The regrouping sweep runs in f64 so that its bound does not rest on f32's
last bits.  Regrouping a sum of n = 144 terms (9 pages of 16 keys) moves it
by at most 2 (n - 1) u sum |p v| / l <= 2 (n - 1) u max |v|, u the unit
roundoff (the weights p / l sum to 1), and the data's |v| stays under
about 4.5: with f64's u = 2^-53 that is 1.4e-13, plus a few ulps from exp
and the split weights, 10^6 times under 1e-6, while a wrong split, mask or
weight moves the output by O(1).  In f32 (u = 2^-24) the same worst case
is 7.7e-5, above 1e-6: the sweep in f32 passed at 0.3 of 1e-6 on every
thread count tried, but once read 1.9e-5 in a full six-worker suite run.

P over code pools (``ref.cancelling_quant_case``: the output is ~1e-7
while sum |p v| / l is ~2.5): the emulation with P (times the v scale)
rounded once to bf16 before the tensor cores misses the JAX quantized
reference by more than 2e-5, and with P split into P_hi + P_lo, as the
kernel does, meets 2e-5.  2e-5 is the file's JAX tolerance: one bf16
rounding of P leaves ~3e-3 on this case, the split ~8e-6 (2^-18 of each
|p v| term) plus f32 sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.kernels import quant as rquant
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref

SPLIT_TOL, JAX_TOL = 1e-6, 2e-5
N_PAGES = 9


def _case(seed, t, cur, *, trash_row=None, b=4, hkv=2, g=2, hd=16, bs=16, n_pages=N_PAGES):
    """A draft block of ``t`` tokens per row at positions cur..cur+t-1, the
    block's pages in the table, later entries at trash block 0."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_pages
    q = rng.standard_normal((b, t, hkv * g, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    kp[0] *= 100.0  # trash-page garbage must never contribute
    vp[0] *= 100.0
    pt = (rng.permutation(nb - 1)[: b * n_pages] + 1).reshape(b, n_pages)
    cl = np.asarray(cur, dtype=np.int32)
    for i in range(b):
        pt[i, (cl[i] + t - 1) // bs + 1:] = 0
    if trash_row is not None:  # a shielded / free slot
        pt[trash_row] = 0
        cl[trash_row] = 0
    return q, kp, vp, pt.astype(np.int32), cl


CASES = [
    dict(t=5, cur=[139, 111, 88, 76]),  # the verify step's positions
    dict(t=2, cur=[0, 15, 16, 100], trash_row=0),
    dict(t=5, cur=[14, 30, 60, 141]),  # row 3's block runs past the table
    dict(t=5, cur=[139, 111, 88, 0], window=32, softcap=30.0, trash_row=3),
    dict(t=5, cur=[139, 130, 127, 100], window=16),
    dict(t=17, cur=[120, 100, 64, 3], g=4),  # 68 rows
]
# Cases where some split has no key any row of a sequence may see: behind
# the window, past cur_len (a shielded row), or past a block that runs off
# the table.
MASKED_SPLIT_CASES = [
    dict(t=5, cur=[139, 139, 139, 139], window=32),
    dict(t=5, cur=[0, 40, 139, 7], trash_row=0),
    dict(t=5, cur=[141, 142, 143, 140]),
]
# Single-token calls (q_len 1): the decode tick's positions, a trash row,
# window plus softcap, splits wholly behind the window, and splits past
# cur_len (their table entries at trash).
SINGLE_CASES = [
    dict(t=1, cur=[143, 115, 92, 80]),
    dict(t=1, cur=[0, 15, 16, 100], trash_row=0),
    dict(t=1, cur=[139, 111, 88, 0], window=32, softcap=30.0, trash_row=3),
    dict(t=1, cur=[143, 143, 143, 143], window=32),
    dict(t=1, cur=[0, 40, 139, 7], trash_row=0),
]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _kw(case):
    return {k: case[k] for k in ("window", "softcap") if k in case}


def _id(case) -> str:
    """A case's test id without spaces, e.g. ``t5-cur139_111_88_76-w32``."""
    tags = {"g": "g", "window": "w", "softcap": "cap", "trash_row": "trash"}
    return "-".join([f"t{case['t']}", "cur" + "_".join(map(str, case["cur"]))]
                    + [f"{tag}{case[k]:g}" for k, tag in tags.items() if k in case])


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("pps", range(1, N_PAGES + 1), ids=lambda p: f"pps{p}")
@pytest.mark.parametrize("case", CASES + MASKED_SPLIT_CASES + SINGLE_CASES, ids=_id)
def test_split_plain_matches_multi_ref(case, pps):
    arrs = _case(1, case["t"], case["cur"], trash_row=case.get("trash_row"),
                 g=case.get("g", 2))
    q, kp, vp, pt, cl = _torch(*arrs)
    q, kp, vp = q.double(), kp.double(), vp.double()
    got = ref.paged_attention_multi_split_plain(q, kp, vp, pt, cl, pages_per_split=pps,
                                                scale=0.25, **_kw(case))
    want = ref.paged_attention_multi_ref(q, kp, vp, pt, cl, scale=0.25, **_kw(case))
    _close(got.numpy(), want.numpy(), SPLIT_TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("case", CASES + MASKED_SPLIT_CASES, ids=_id)
def test_split_plain_matches_pallas_kernel(case):
    arrs = _case(2, case["t"], case["cur"], trash_row=case.get("trash_row"),
                 g=case.get("g", 2))
    pps = PA.plan_split(4, 2, case["t"], case.get("g", 2), N_PAGES, 16).pages_per_split
    got = ref.paged_attention_multi_split_plain(*_torch(*arrs), pages_per_split=pps,
                                                **_kw(case))
    want = rops.paged_attention_multi(*map(jnp.asarray, arrs), **_kw(case))
    _close(got.numpy(), np.asarray(want), JAX_TOL)


def _quantized(kp, vp, kv_dtype):
    """Reference-quantized pools as numpy: k codes, v codes, k scales, v
    scales (fp8 codes in the reference's ml_dtypes type)."""
    out = []
    for pool in (kp, vp):
        s = rquant.scales_of(jnp.asarray(pool), kv_dtype)
        out.append((np.array(rquant.quantize(jnp.asarray(pool), s, kv_dtype)), np.array(s)))
    (kc, ks), (vc, vs) = out
    return kc, vc, ks, vs


def _torch_codes(a):
    if a.dtype == np.int8:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", [CASES[0], CASES[3], *MASKED_SPLIT_CASES], ids=_id)
def test_split_plain_quant_matches_pallas_kernel(case, kv_dtype):
    q, kp, vp, pt, cl = _case(3, case["t"], case["cur"], trash_row=case.get("trash_row"))
    kc, vc, ks, vs = _quantized(kp, vp, kv_dtype)
    got = ref.paged_attention_multi_split_plain(
        torch.from_numpy(q), _torch_codes(kc), _torch_codes(vc), *_torch(pt, cl),
        pages_per_split=2, k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
        **_kw(case))
    want = rops.paged_attention_multi_quant(*map(jnp.asarray, (q, kc, vc, ks, vs, pt, cl)),
                                            **_kw(case))
    _close(got.numpy(), np.asarray(want), JAX_TOL)
    oracle = ref.paged_attention_multi_quant_ref(
        torch.from_numpy(q), _torch_codes(kc), _torch_codes(vc), torch.from_numpy(ks),
        torch.from_numpy(vs), *_torch(pt, cl), **_kw(case))
    _close(got.numpy(), oracle.numpy(), SPLIT_TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("case", SINGLE_CASES, ids=_id)
def test_split_plain_single_token_matches_pallas_kernel(case, kv_dtype):
    """q_len 1 through the split arithmetic, as the single-token entries run
    it, against the JAX package's single-token kernel (full-precision or
    quantized pools)."""
    q, kp, vp, pt, cl = _case(6, 1, case["cur"], trash_row=case.get("trash_row"))
    pps = PA.plan_split(4, 2, 1, 2, N_PAGES, 16).pages_per_split
    if kv_dtype is None:
        got = ref.paged_attention_multi_split_plain(*_torch(q, kp, vp, pt, cl),
                                                    pages_per_split=pps, **_kw(case))
        want = rops.paged_attention(*map(jnp.asarray, (q[:, 0], kp, vp, pt, cl)), **_kw(case))
    else:
        kc, vc, ks, vs = _quantized(kp, vp, kv_dtype)
        got = ref.paged_attention_multi_split_plain(
            torch.from_numpy(q), _torch_codes(kc), _torch_codes(vc), *_torch(pt, cl),
            pages_per_split=pps, k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
            **_kw(case))
        want = rops.paged_attention_quant(*map(jnp.asarray, (q[:, 0], kc, vc, ks, vs, pt, cl)),
                                          **_kw(case))
    _close(got[:, 0].numpy(), np.asarray(want), JAX_TOL)


def _jax_codes(t):
    """Torch int8 / fp8 codes as a JAX array of the same type."""
    if t.dtype == torch.int8:
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_p_over_code_pools_needs_f32_accuracy(kv_dtype, t):
    """The kernel's P V over code pools in plain PyTorch: on a case whose V
    codes cancel, P rounded once to bf16 misses the JAX quantized
    reference, P_hi + P_lo meets it."""
    q, kc, vc, ks, vs, pt, cl = ref.cancelling_quant_case(7, t, kv_dtype)
    jargs = (jnp.asarray(q.numpy()), _jax_codes(kc), _jax_codes(vc), jnp.asarray(ks.numpy()),
             jnp.asarray(vs.numpy()), jnp.asarray(pt.numpy()), jnp.asarray(cl.numpy()))
    if t == 1:
        want = np.asarray(rops.paged_attention_quant(jargs[0][:, 0], *jargs[1:]))[:, None]
    else:
        want = np.asarray(rops.paged_attention_multi_quant(*jargs))
    assert np.abs(want).max() < 1e-5  # the values cancel ...
    weight = ref.paged_attention_multi_quant_ref(q, kc, vc.float().abs().to(vc.dtype), ks, vs,
                                                 pt, cl)
    assert weight.abs().max() > 1.0  # ... out of sum |p v| / l of order 1
    err = {}
    for bits in ("bf16", "bf16x2"):
        got = ref.paged_attention_multi_split_plain(q, kc, vc, pt, cl, pages_per_split=2,
                                                    k_scale=ks, v_scale=vs, p_bits=bits)
        err[bits] = np.abs(got.numpy() - want).max()
    assert err["bf16"] > JAX_TOL, err
    assert err["bf16x2"] <= JAX_TOL, err


def test_a_split_behind_the_window_has_no_keys():
    """With window 32 at cur_len 139 the first splits of 2 pages hold no key
    any row may see, and the result still equals the reference."""
    case = MASKED_SPLIT_CASES[0]
    q, kp, vp, pt, cl = _torch(*_case(4, case["t"], case["cur"]))
    q, kp, vp = q.double(), kp.double(), vp.double()
    lo = 139 - case["window"] + 1  # the oldest row's first visible key
    assert lo // 16 >= 2 * 3  # splits 0-2 (pages 0-5) lie wholly behind it
    vp_poisoned = vp.clone()
    for j in range(6):  # poison those pages: they must carry zero weight
        vp_poisoned[pt[:, j].long()] = 1e4
    got = ref.paged_attention_multi_split_plain(q, kp, vp_poisoned, pt, cl,
                                                pages_per_split=2, window=32)
    want = ref.paged_attention_multi_ref(q, kp, vp, pt, cl, window=32)
    _close(got.numpy(), want.numpy(), SPLIT_TOL)


@pytest.mark.parametrize("shape,want", [
    # (B, Hkv, q_len, g, n_pages, hd) -> (tiles, tile_rows, pps, splits, grid, workspace)
    ((4, 8, 5, 4, 9, 128), (1, 20, 2, 5, (4, 8, 5), (4 * 8 * 5 * 20, 130))),  # verify
    ((4, 8, 5, 4, 128, 128), (1, 20, 8, 16, (4, 8, 16), (4 * 8 * 16 * 20, 130))),  # long
    ((1, 8, 5, 4, 9, 128), (1, 20, 2, 5, (1, 8, 5), (8 * 5 * 20, 130))),  # B = 1
    ((4, 8, 17, 4, 9, 128), (2, 34, 2, 5, (4, 8, 10), (4 * 8 * 5 * 68, 130))),  # 68 rows
    ((4, 8, 2, 4, 1, 64), (1, 8, 1, 1, (4, 8, 1), None)),  # one page: no split
    ((64, 8, 5, 4, 9, 128), (1, 20, 5, 2, (64, 8, 2), (64 * 8 * 2 * 20, 130))),
    ((128, 8, 5, 4, 9, 128), (1, 20, 9, 1, (128, 8, 1), None)),  # 1024 pairs: no split
    ((4, 8, 1, 4, 9, 128), (1, 4, 2, 5, (4, 8, 5), (640, 130))),  # decode tick
    ((4, 8, 1, 4, 128, 128), (1, 4, 8, 16, (4, 8, 16), (4 * 8 * 16 * 4, 130))),  # long
], ids=lambda v: str(v).replace(" ", ""))
def test_plan_split(shape, want):
    p = PA.plan_split(*shape)
    assert (p.tiles, p.tile_rows, p.pages_per_split, p.n_splits, p.grid,
            p.workspace_shape) == want
    b, hkv, t, g, n_pages, _ = shape
    assert p.tiles * p.tile_rows >= t * g and p.tile_rows <= PA.MAX_TILE_ROWS
    assert (p.n_splits - 1) * p.pages_per_split < n_pages <= p.n_splits * p.pages_per_split
    assert p.blocks == b * hkv * p.tiles * p.n_splits


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n_pages", [1, 2, 3, 9, 33, 128, 1000])
def test_plan_split_rules(b, n_pages):
    """At least MIN_PAGES_PER_SPLIT pages a split where the table has them,
    and no more blocks than needed for about TARGET_BLOCKS."""
    p = PA.plan_split(b, 8, 5, 4, n_pages, 128)
    assert p.pages_per_split >= min(PA.MIN_PAGES_PER_SPLIT, n_pages)
    pairs = b * 8 * p.tiles
    assert p.n_splits == 1 or pairs * (p.n_splits - 1) < PA.TARGET_BLOCKS


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_every_config_runs_the_split_body(arch):
    """Every configuration's head_dim, full and smoke, goes to the split
    body; a head_dim that is not a multiple of 16 to the walk body."""
    for cfg in (rconfigs.get_config(arch), rconfigs.get_smoke_config(arch)):
        assert PA.single_token_body(cfg.head_dim) == "split", (arch, cfg.head_dim)
    assert PA.single_token_body(24) == "walk"
