"""The port's CUDA kernels on a card: each against its plain version, and
the engine on the card against the engine on the CPU.  Every test carries
the ``cuda`` marker and skips without a card.  The file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances (max abs, kernel vs plain): f32 1e-5 (sums in another order),
bf16 2e-2 (one bf16 ulp at the outputs' magnitude).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import transformer as T
from repro_torch.runtime import serving

pytestmark = pytest.mark.cuda
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    dict(cur=[0, 15, 16, 100], trash_row=0),
    dict(cur=[143, 100, 15, 16]),
    dict(cur=[143, 100, 15, 16], window=32),
    dict(cur=[143, 100, 15, 0], softcap=30.0, trash_row=3),
    dict(cur=[7, 3, 12, 0], hd=64, g=2, bs=8),
], ids=str)
def test_paged_kernel_matches_plain(cuda, dtype, case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    shape = {k: case[k] for k in ("hd", "g", "bs") if k in case}
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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    dict(sq=64, q_offset=0), dict(sq=64, q_offset=64), dict(sq=36, q_offset=64),
    dict(sq=5, q_offset=0, g=1), dict(sq=64, q_offset=64, window=32, softcap=30.0),
    dict(sq=13, q_offset=6, window=5, hd=16, b=2),
], ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    kw = {k: case[k] for k in ("window", "softcap") if k in case}
    gen = torch.Generator().manual_seed(1)
    b, hd, hkv, g = case.get("b", 1), case.get("hd", 128), 8, case.get("g", 4)
    sq, off = case["sq"], case["q_offset"]
    q = torch.randn((b, sq, hkv * g, hd), generator=gen).to(cuda, dtype)
    k = torch.randn((b, off + sq, hkv, hd), generator=gen).to(cuda, dtype)
    v = torch.randn((b, off + sq, hkv, hd), generator=gen).to(cuda, dtype)
    n0 = FA.KERNEL.launches
    got = ops.flash_attention(q, k, v, q_offset=off, **kw)
    want = FA.flash_attention_plain(q, k, v, scale=1 / math.sqrt(hd), q_offset=off, **kw)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def test_kernel_wrappers_raise_on_unsupported_cuda_inputs(cuda):
    q, kp, vp, pt, cl = (t.to(cuda) for t in _paged(torch.float32, [1, 2, 3, 4]))
    with pytest.raises(ValueError, match="query heads per kv head"):
        wide = torch.zeros((4, 8 * 17, 128), device=cuda)
        ops.paged_attention(wide, kp, vp, pt, cl)
    with pytest.raises(ValueError, match="device"):
        ops.paged_attention(q.cpu(), kp, vp, pt, cl)


def test_engine_on_card_matches_cpu(cuda):
    """Smoke qwen3-4b (head_dim 16, 2 query heads per kv head) served on the
    card through both kernels and on the CPU through the plain versions:
    greedy tokens identical per request."""
    cfg = configs.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    scfg = serving.ServeConfig(max_seq=48, prefill_chunk=16, max_new_tokens=6,
                               max_batch=2, block_size=8)
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


def _to(v, dev):
    return {k: _to(x, dev) for k, x in v.items()} if isinstance(v, dict) else v.to(dev)
