"""paligemma-3b (smoke config: an 8-row image prefix, head_dim 16, g = 4)
in the port against the JAX package on the CPU, f32:

* the plain prefill with ``prefix_len`` (``kernels/ref.flash_attention_ref``,
  the card's fallback-free yardstick) against the reference's
  ``attention.flash_attention_ref`` over prefix / chunk / ``q_offset``
  cases, within 1e-5; the tensor-core body's emulation with the prefix
  against the plain version on bf16-exact inputs, within 2e-2 (the kernel's
  bf16 tolerance);
* the model's first chunk (image prefix scaled as the embeddings, seen
  bidirectionally) against the reference's ``prefill``, within 1e-5;
* ``ServingEngine.generate(prefix_embeds=)`` tokens equal to the JAX
  ``ServingEngine.generate``, in one chunk and in several;
* ``StreamedBatchEngine`` rejects the config with the reference's
  "prefix-LM" message before touching the params; the launcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.models import transformer as PT
from repro_torch.runtime import serving as PS

ARCH = "paligemma-3b"
TOL = dict(atol=1e-5, rtol=1e-5)


def _numpy_params(cfg, seed=0):
    """Reference init as numpy, rmsnorm scales set to random non-zero values
    (zero at init, so the ``1 + scale`` gain would otherwise go untested)."""
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "scale":
                t[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
    fill(tree)
    return tree


@pytest.fixture(scope="module")
def pali():
    rcfg, pcfg = RC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    tree = _numpy_params(rcfg)
    return rcfg, pcfg, tree, bridge.params_from_numpy(tree, pcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# (Sq, Sk, q_offset, prefix_len, chunk of the reference's block pairs): a
# first chunk with its prefix, a prefix not a multiple of the chunk, a
# later chunk (a prefix changes nothing there), a prefix past a later
# chunk's causal limit (held to the reference's ``naive_attention`` only:
# its ``flash_attention_ref`` needs a query block covering the prefix), a
# prefix of a whole chunk.
PREFIX_CASES = [(24, 24, 0, 8, 16), (40, 40, 0, 13, 16), (16, 40, 24, 8, 8),
                (12, 40, 20, 30, 8), (32, 32, 0, 16, 16)]


@pytest.mark.parametrize("case", PREFIX_CASES, ids=str)
@pytest.mark.parametrize("g", [1, 4])
def test_plain_prefill_with_prefix_matches_reference(case, g):
    sq, sk, off, prefix, chunk = case
    rng = np.random.default_rng(sq + sk + g)
    hkv, hd = 2, 16
    q = rng.standard_normal((2, sq, hkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, hd)).astype(np.float32)
    got = pops.flash_attention(_t(q), _t(k), _t(v), q_offset=off, prefix_len=prefix)
    if sq >= prefix:  # its block pairs need a query block covering the prefix
        want = RA.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      chunk=chunk, prefix_len=prefix, q_offset=off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    naive = RA.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               prefix_len=prefix, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(naive), **TOL)
    # The tensor-core body's rounding (bf16 q/k/v, P rounded to bf16 per
    # 16-key tile, 4 key splits) keeps the prefix mask.
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    tc = pref.flash_attention_tc_plain(qb, kb, vb, q_offset=off, prefix_len=prefix,
                                       key_splits=4)
    plain = pref.flash_attention_ref(qb.float(), kb.float(), vb.float(), q_offset=off,
                                     prefix_len=prefix)
    assert (tc.float() - plain).abs().max().item() <= 2e-2


def test_prefix_len_must_be_non_negative():
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="prefix_len"):
        pops.flash_attention(x, x, x, prefix_len=-1)


def test_first_chunk_matches_reference(pali):
    """The image prefix scaled by sqrt(d_model) in the compute type, put
    before the tokens, seen bidirectionally: the first chunk's logits and
    the cache rows against the reference's ``prefill``."""
    rcfg, pcfg, tree, params = pali
    rng = np.random.default_rng(4)
    toks = rng.integers(0, rcfg.vocab_size, (2, 12)).astype(np.int32)
    pre = rng.standard_normal((2, rcfg.prefix_len, rcfg.d_model)).astype(np.float32)
    want, rcache = RT.prefill(rcfg, jax.tree.map(jnp.asarray, tree),
                              {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pre)},
                              max_seq=32)
    caches = PT.init_cache(pcfg, 2, 32, ring=False, device="cpu")
    got, caches = PT.prefill_chunk(pcfg, params, _t(toks), caches, 0,
                                   unembed=PT.unembed_f32(pcfg, params), prefix=_t(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(caches["blocks"]["layer0"]["k"].numpy(),
                               np.asarray(rcache["blocks"]["layer0"]["k"]), **TOL)


@pytest.mark.parametrize("chunk", [32, 8], ids=["one-chunk", "three-chunks"])
def test_generate_matches_reference(pali, chunk):
    rcfg, pcfg, tree, params = pali
    rng = np.random.default_rng(chunk)
    toks = rng.integers(0, rcfg.vocab_size, (3, 20)).astype(np.int32)
    pre = (0.1 * rng.standard_normal((3, rcfg.prefix_len, rcfg.d_model))).astype(np.float32)
    scfg = dict(max_seq=48, prefill_chunk=chunk, max_new_tokens=6)
    want = RS.ServingEngine(rcfg, jax.tree.map(jnp.asarray, tree), RS.ServeConfig(**scfg)
                            ).generate(jnp.asarray(toks), prefix_embeds=jnp.asarray(pre))
    eng = PS.ServingEngine(pcfg, params, PS.ServeConfig(**scfg), device="cpu",
                           unembed=PT.unembed_f32(pcfg, params))
    np.testing.assert_array_equal(eng.generate(toks, prefix_embeds=pre).numpy(),
                                  np.asarray(want))
    positions = [p for _, _, p in eng.iter_prefill_chunks(_t(toks), prefix_embeds=pre)]
    assert positions[0] == rcfg.prefix_len + min(chunk, 20) and positions[-1] == 28


def test_generate_needs_its_prefix(pali):
    _, pcfg, _, params = pali
    eng = PS.ServingEngine(pcfg, params, PS.ServeConfig(max_seq=48, prefill_chunk=8),
                           device="cpu", unembed=PT.unembed_f32(pcfg, params))
    toks = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.generate(toks)
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.generate(toks, prefix_embeds=np.zeros((2, 3, pcfg.d_model), np.float32))


def test_batched_engine_rejects_prefix_lm():
    """Before the params are touched (they are ``{}`` here), as the
    reference's ``build_servable``."""
    rcfg, pcfg = RC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError) as want:
        RS.StreamedBatchEngine(rcfg, {}, RS.ServeConfig())
    with pytest.raises(NotImplementedError, match="prefix-LM") as got:
        PS.StreamedBatchEngine(pcfg, {}, PS.ServeConfig(), device="cpu")
    assert str(got.value) == str(want.value)


def test_launcher_serves_paligemma_on_cpu(capsys):
    from repro_torch.launch import serve as pserve
    pserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "sequential-batch" in out and "3 requests x 20 prompt -> 4 new tokens each" in out
