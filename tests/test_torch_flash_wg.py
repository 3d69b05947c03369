"""The prefill kernel's wgmma body (``csrc/flash_attention.cu``,
``flash_attention_wg_kernel``) on the CPU: its plans at the shapes it was
built for, the analyzer's coverage rule for them, and its arithmetic
through the plain emulation ``ref.flash_attention_tc_plain`` (key tiles of
128, or 64 at head_dim 256; P rounded to bf16 per tile; the keys cut into
contiguous runs of tiles, one a block, combined at the end) against the
JAX package's ``flash_attention_ref`` and its Pallas kernel in interpret
mode.  The kernel itself runs only on a card: ``tests/test_torch_cuda.py``.

Tolerances, as ``test_torch_tc_numerics.py`` holds the tc body's emulation:
one bf16 ulp at the reference output's largest magnitude (2^(floor(log2
max|want|) - 7)) and at least 99% of the outputs bit-equal to the
reference at chunk = the key tile (the same P rounding at the same tiles;
only f32 sums in another order differ) with one split; with several
splits each split rounds P against its own running max, so two ulps."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.models import attention as rattn
from repro_torch.analysis import kernelcheck
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.runtime import graphs as G

BF16 = torch.bfloat16
EQUAL_SHARE = 0.99


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _case(seed, *, sq, sk, g, hd=32, hkv=2, b=2):
    """bf16 q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) from numpy, and the same
    values as JAX arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hkv * g, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]
    ts = [torch.from_numpy(a).to(BF16) for a in arrs]
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]
    return ts, js


def _as_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


# -- the plans ------------------------------------------------------------------------

# (B, Sq, H, Hkv, hd, Sk) -> (block rows, key tile, key splits): PERF.md's rows
# 4b (paligemma's first chunk), 4c (whisper's encoder and cross-attention), 4d
# (training's forward), phase 15's one-shot prefill and the long context.
WG_SHAPES = {
    "4b paligemma prefix": ((1, 320, 8, 1, 256, 320), (64, 64, 1)),
    "4c whisper encoder": ((1, 1500, 16, 16, 64, 1500), (192, 128, 1)),
    "4c whisper cross": ((1, 64, 16, 16, 64, 1500), (64, 128, 6)),
    "4d training 4 x 512": ((4, 512, 32, 8, 128, 512), (128, 128, 1)),
    "15 one-shot prefill 2 x 512": ((2, 512, 32, 8, 128, 512), (128, 128, 1)),
    "long context Sq 64 at Sk 2048": ((1, 64, 32, 8, 128, 2048), (128, 128, 8)),
}


@pytest.mark.parametrize("name", list(WG_SHAPES))
def test_plan_flash_picks_the_wg_body(name):
    """The grid covers the Sq * g rows of a kv head in 64-row tiles (one to
    three a block), every key tile lies in exactly one split, none empty,
    and the analyzer's coverage rule agrees."""
    (b, sq, h, hkv, hd, sk), (block_rows, key_tile, splits) = WG_SHAPES[name]
    plan = FA.plan_flash(b, sq, h, hkv, hd, BF16, sk=sk)
    assert plan.body == "wg"
    assert (plan.block_rows, plan.key_tile, plan.key_splits) == (block_rows, key_tile, splits)
    assert plan.warps == 4 * block_rows // 64 + 1
    rows = sq * (h // hkv)
    m_tiles = plan.grid[0] // splits
    assert plan.grid == (m_tiles * splits, hkv, b)
    assert m_tiles * block_rows >= rows > (m_tiles - 1) * block_rows
    tiles = -(-sk // key_tile)
    per_split = FA.tiles_per_split(plan, sk)
    assert splits * per_split >= tiles > (splits - 1) * per_split
    shape = dict(batch=b, sq=sq, n_heads=h, n_kv=hkv, head_dim=hd, sk=sk)
    assert kernelcheck._check_flash(plan, shape) == []


def test_plan_flash_key_split_fills_the_card():
    """A split where the m-tiles' blocks fill at most a quarter of the SMs:
    up to SMS blocks, at least two key tiles a split; none otherwise."""
    cross = FA.plan_flash(1, 64, 16, 16, 64, BF16, sk=1500)
    assert cross.blocks == 96 and FA.tiles_per_split(cross, 1500) == FA.WG_MIN_SPLIT_TILES
    enc = FA.plan_flash(1, 1500, 16, 16, 64, BF16, sk=1500)  # 3 warpgroups: one wave
    assert enc.blocks == 128 <= FA.SMS and enc.key_splits == 1
    long = FA.plan_flash(1, 64, 32, 8, 128, BF16, sk=2048)
    assert long.blocks == 128 and long.key_splits == 8
    prefix = FA.plan_flash(1, 320, 8, 1, 256, BF16, sk=320)  # 40 blocks > SMS / 4
    assert prefix.blocks == 40 and prefix.key_splits == 1
    one_tile = FA.plan_flash(1, 2048, 4, 4, 128, BF16, sk=100)
    assert one_tile.body == "wg" and one_tile.key_splits == 1
    assert FA.tiles_per_split(one_tile, 100) == 1


def test_plan_flash_crossover():
    """The wgmma body from WG_MIN_KEYS keys or WG_MIN_WORK rows x keys a kv
    head; the serve's chunks below both stay on the tc body."""
    assert FA.plan_flash(1, 64, 32, 8, 128, BF16, sk=448).body == "tc"   # 256 x 448
    assert FA.plan_flash(1, 64, 32, 8, 128, BF16, sk=512).body == "wg"   # WG_MIN_KEYS
    assert FA.plan_flash(1, 64, 8, 1, 256, BF16, sk=384).body == "wg"    # 512 x 384
    assert FA.plan_flash(1, 64, 64, 8, 128, BF16, sk=128).body == "tc"   # 512 x 128
    assert FA.plan_flash(1, 256, 32, 8, 128, BF16, sk=256).body == "wg"  # 1024 x 256


@pytest.mark.parametrize("shape", [
    (1, 64, 32, 8, 128, 128),   # the serve's chunk (row 4)
    (1, 64, 32, 8, 128, 192),
    (1, 64, 64, 8, 128, 192),   # jamba's chunk, g 8
    (1, 64, 16, 16, 64, 128),   # whisper's decoder chunk
    (1, 320, 8, 1, 32, 1500),   # a head_dim the wgmma body has no instance of
])
def test_plan_flash_keeps_the_tc_body(shape):
    b, sq, h, hkv, hd, sk = shape
    plan = FA.plan_flash(b, sq, h, hkv, hd, BF16, sk=sk)
    assert plan == FA.FlashPlan("tc", (-(-sq * (h // hkv) // 16), hkv, b), 4, 4, 16)


def test_kernel_meta_lints_wg_shapes_and_catches_a_bad_split():
    meta = FA.KERNEL_META["flash_attention"]
    plans = [meta["plan"](**s) for s in meta["lint_shapes"]]
    assert {p.body for p in plans} == {"simt", "tc", "wg"}
    assert kernelcheck.check_layout("flash_attention", meta) == []
    shape = dict(batch=1, sq=64, n_heads=16, n_kv=16, head_dim=64, sk=1500)
    good = FA.plan_flash(dtype=BF16, **shape)
    m_tiles = good.grid[0] // good.key_splits
    empty = FA.FlashPlan("wg", (m_tiles * 9, *good.grid[1:]), good.warps, 9, good.key_tile)
    assert any("key splits" in m for m in kernelcheck._check_flash(empty, shape))  # 9 x 2 > 12
    wide = FA.FlashPlan("wg", good.grid, 9, good.key_splits, good.key_tile)
    assert any("m-tiles" in m for m in kernelcheck._check_flash(
        wide, dict(shape, sq=200)))


# -- the launch counts -----------------------------------------------------------------


def test_body_counts_are_launch_counts_graphs_account_for():
    """Each body's count is a part of the kernel's launches
    (``CudaKernel.parts``, the part the wrapper names), so a graph capture
    takes its launches back out and a replay adds them, as for the kernel's
    own count; the CPU path counts nothing."""
    (q, k, v), _ = _case(0, sq=8, sk=8, g=2)
    n0 = (FA.KERNEL.launches, dict(FA.KERNEL.parts))
    FA.flash_attention(q, k, v, scale=0.5)
    assert (FA.KERNEL.launches, FA.KERNEL.parts) == n0
    kernel = _build.CudaKernel("flash_attention.cu", "test_only", [])
    kernel._bind = lambda: (lambda *args: 0)  # a launch that succeeds, on no card

    class Capture:  # a capture stand-in: runs fn once, replays count
        replays = 0

        def __call__(self, fn):
            out = fn()
            backend = self

            class Graph:
                def replay(self):
                    backend.replays += 1  # runs no Python: graphs adds the count
            return Graph(), out

    def fn(x):
        kernel.launch(part="wg")  # as _launch names the planned body
        return x + 1

    try:
        graphs = G.Graphs(torch.device("cpu"), capture=Capture())
        step = G.StepGraph(graphs, fn, {"x": ((2,), torch.int32)})
        step(x=np.zeros(2, np.int32))  # eager
        step(x=np.zeros(2, np.int32))  # captured (its launch taken back out), then replayed
        step(x=np.zeros(2, np.int32))  # replayed
        assert step.launches == {kernel: 1} and step.parts == {kernel: {"wg": 1}}
        assert kernel.launches == 3 and kernel.parts == {"wg": 3}
    finally:
        _build.KERNELS.remove(kernel)


# -- the arithmetic ----------------------------------------------------------------------

# Sk a multiple of the key tile, so that the reference's key chunk is the tile.
EMUL_CASES = [
    dict(sq=256, sk=256, g=1),
    dict(sq=128, sk=256, g=4, window=100),
    dict(sq=128, sk=384, g=4, softcap=5.0, hd=64),
    dict(sq=64, sk=384, g=2, causal=False),
    dict(sq=256, sk=256, g=4, prefix_len=100),
    dict(sq=96, sk=192, g=8, key_tile=64),  # the head_dim 256 tile
]


def _kw(case):
    return dict(window=case.get("window", 0), softcap=case.get("softcap", 0.0),
                causal=case.get("causal", True), prefix_len=case.get("prefix_len", 0))


@pytest.mark.parametrize("case", EMUL_CASES, ids=str)
def test_wg_emulation_matches_flash_attention_ref(case):
    tile = case.get("key_tile", 128)
    off = case["sk"] - case["sq"] if case.get("causal", True) else 0
    (q, k, v), (qj, kj, vj) = _case(1, sq=case["sq"], sk=case["sk"], g=case["g"],
                                    hd=case.get("hd", 32))
    kw = _kw(case)
    want = _as_torch(rattn.flash_attention_ref(
        qj, kj, vj, chunk=tile, q_offset=off, window=kw["window"], softcap_val=kw["softcap"],
        causal=kw["causal"], prefix_len=kw["prefix_len"]))
    ulp = _ulp(want.abs().max().item())
    got = ref.flash_attention_tc_plain(q, k, v, q_offset=off, key_tile=tile,
                                       contiguous=True, **kw).float()
    assert (got - want).abs().max().item() <= ulp
    assert (got == want).float().mean().item() >= EQUAL_SHARE
    for per_split in (1, 2):
        got = ref.flash_attention_tc_plain(q, k, v, q_offset=off, key_tile=tile,
                                           key_splits=-(-case["sk"] // (tile * per_split)),
                                           contiguous=True, **kw)
        assert (got.float() - want).abs().max().item() <= 2 * ulp
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("kw", [dict(), dict(window=100), dict(softcap=20.0)], ids=str)
@pytest.mark.parametrize("g", [1, 4])
def test_wg_emulation_matches_pallas_kernel(kw, g):
    """Block-divisible shapes, q_offset 0: the Pallas kernel in interpret
    mode with key blocks of the wgmma body's tile."""
    (q, k, v), (qj, kj, vj) = _case(2, sq=256, sk=256, g=g)
    want = _as_torch(rops.flash_attention(qj, kj, vj, block_q=128, block_k=128,
                                          interpret=True, **kw))
    got = ref.flash_attention_tc_plain(q, k, v, key_tile=128, contiguous=True, **kw).float()
    assert (got - want).abs().max().item() <= _ulp(want.abs().max().item())
    assert (got == want).float().mean().item() >= EQUAL_SHARE


def test_contiguous_splits_differ_from_round_robin():
    """The two split layouts are different arithmetic (which tiles share a
    running max), each within two ulps of the plain version."""
    (q, k, v), _ = _case(3, sq=64, sk=512, g=2)
    kw = dict(causal=False)
    runs = ref.flash_attention_tc_plain(q, k, v, key_tile=64, key_splits=2, contiguous=True,
                                        **kw)
    robin = ref.flash_attention_tc_plain(q, k, v, key_tile=64, key_splits=2, **kw)
    plain = FA.flash_attention_plain(q.float(), k.float(), v.float(), scale=32 ** -0.5, **kw)
    ulp = _ulp(plain.abs().max().item())
    assert not torch.equal(runs, robin)
    for got in (runs, robin):
        assert (got.float() - plain).abs().max().item() <= 2 * ulp
