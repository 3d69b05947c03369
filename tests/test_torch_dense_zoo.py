"""The port's dense zoo against the JAX reference on the CPU, f32, equal
weights through the bridge: gemma2-27b, internlm2-20b and phi4-mini-3.8b
(smoke configs).

* the FFN kinds (swiglu, geglu with the tanh-approximate gelu, gelu_mlp),
  within 1e-5;
* gemma2's two layers (local and global, sandwich norms) and the whole
  model over a contiguous cache whose local layers are a ring of
  ``sliding_window`` rows while the global layer keeps ``max_seq`` (the
  reference's ``prefill`` then ``decode_step``), within 1e-4 (sums of two
  layers and a vocabulary product in another order);
* the plain paged entries and the prefill at the zoo's grouped-query
  ratios (g = 2, 3, 6) with head_dim 128, gemma2's query scale, softcap 50
  and a window that bites, against the JAX package's Pallas kernels in
  interpret mode, within 2e-5 (``tests/test_torch_kernels.py``'s);
* the engine's greedy tokens per uid equal the JAX ``StreamedBatchEngine``'s
  paged (fused prefill), contiguous and with n-gram speculative decode;
  over int8 pages the mean agreement reaches the reference's floor, 0.5
  (more options: ``tests/test_torch_zoo_options.py``).

gemma2's smoke config already has a 16-token window (``smoke_reduce``), so
its window bites on the longer prompts; its softcaps of 50 and 30 do not
bend on a smoke model's logits.  A variant, built with
``dataclasses.replace`` on both sides, sets ``attn_softcap=5.0`` and
``final_softcap=3.0``, and its logits test scales the embedding so that
the final cap bends the logits."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import ops as rops
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.runtime import serving as RS
from repro_torch import bridge
from repro_torch import configs as PC
from repro_torch.kernels import ops as pops
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.runtime import serving as PS

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
JAX_TOL = 2e-5
QUANT_FLOOR = 0.5
LENS = (24, 17, 40, 9, 33, 16)
KW = dict(max_seq=48, prefill_chunk=16, max_new_tokens=6, max_batch=2, block_size=8)
SOFTCAPPED = dict(sliding_window=16, attn_softcap=5.0, final_softcap=3.0)


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


def _configs(arch, **over):
    return (dataclasses.replace(RC.get_smoke_config(arch), **over),
            dataclasses.replace(PC.get_smoke_config(arch), **over))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# -- layers -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu_mlp"])
def test_ffn_kinds_match_reference(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 2.0
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.5
         for k, s in (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)))}
    if kind == "gelu_mlp":
        del p["wg"]
    want = np.asarray(RL.ffn_apply(_j(p), jnp.asarray(x), kind=kind))
    got = PL.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x), kind=kind)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    init = PL.ffn_init(torch.Generator().manual_seed(0), 16, 32, torch.float32, kind=kind)
    assert set(init) == set(RL.ffn_init(jax.random.PRNGKey(0), 16, 32, jnp.float32,
                                        kind=kind))
    if kind != "swiglu":  # the reference's gelu is the tanh approximation
        h = _t(x) @ _t(p["wg" if kind == "geglu" else "wi"])
        gap = (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(h, approximate="tanh"))
        assert gap.abs().max().item() > 1e-4
    with pytest.raises(ValueError, match="unknown ffn kind"):
        PL.ffn_apply(p, _t(x), kind="relu")


@pytest.mark.parametrize("over", [{}, SOFTCAPPED], ids=["smoke", "softcapped"])
def test_gemma2_layers_match_reference(over):
    """One local and one global layer from equal hidden states: attention
    with the query scale, softcap and window, sandwich norms, geglu."""
    rcfg, pcfg = _configs("gemma2-27b", **over)
    tree = _numpy_params(rcfg)
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    assert {"post_mixer_norm", "post_ffn_norm"} <= set(params["blocks"]["layer0"])
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 24, rcfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    for i, (rs, ps) in enumerate(zip(rcfg.layer_unit, pcfg.layer_unit)):
        pr = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"][f"layer{i}"])
        want, _, _ = RT._apply_layer(rcfg, rs, pr, jnp.asarray(h), positions=jnp.asarray(pos),
                                     cache=None, cur_len=None, enc_out=None, prefix_len=0,
                                     causal=True)
        got, _ = PT._apply_layer(pcfg, ps, PT._at(params["blocks"][f"layer{i}"], 0), _t(h),
                              positions=_t(pos), cache=None, cur_len=None, q_offset=0,
                              page_table=None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("over", [{}, SOFTCAPPED], ids=["smoke", "softcapped"])
def test_gemma2_ring_cache_prefill_and_decode_match_reference(over):
    """The reference's ``prefill`` (a ring of ``sliding_window`` rows on the
    local layers, ``max_seq`` rows on the global one) then 6 decode steps
    against the port's ``init_cache(ring=True)``, ``prefill_chunk`` and
    ``decode_step``: logits within 1e-4, the caches' shapes and rows equal.
    The softcapped variant's embedding is scaled so that its final cap of 3
    bends the logits."""
    rcfg, pcfg = _configs("gemma2-27b", **over)
    tree = _numpy_params(rcfg)
    if over:
        tree["embed"] = tree["embed"] * 40.0
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    unembed = PT.unembed_f32(pcfg, params)
    b, s, max_seq = 2, 24, 40
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    logits_r, caches_r = RT.prefill(rcfg, _j(tree), {"tokens": jnp.asarray(tokens)},
                                    max_seq=max_seq)
    caches = PT.init_cache(pcfg, b, max_seq, ring=True, device="cpu")
    for i in range(2):
        rows = caches["blocks"][f"layer{i}"]["k"].shape[2]
        assert rows == (pcfg.sliding_window if i == 0 else max_seq)
        assert rows == caches_r["blocks"][f"layer{i}"]["k"].shape[2]
    logits_p, _ = PT.prefill_chunk(pcfg, params, _t(tokens), caches, 0, unembed=unembed)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **MODEL_TOL)
    if over:
        assert np.abs(np.asarray(logits_r)).max() > 0.5 * rcfg.final_softcap
    cur = np.full((b,), s, np.int32)
    tok = np.asarray(jnp.argmax(logits_r[:, -1], -1)).astype(np.int32)[:, None]
    for _ in range(6):
        logits_r, caches_r = RT.decode_step(rcfg, _j(tree), jnp.asarray(tok), caches_r,
                                            jnp.asarray(cur))
        logits_p, _ = PT.decode_step(pcfg, params, _t(tok), caches, _t(cur), unembed=unembed)
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r), **MODEL_TOL)
        tok = np.asarray(jnp.argmax(logits_r[:, -1], -1)).astype(np.int32)[:, None]
        cur = cur + 1
    for i in range(2):
        for key in ("k", "v"):
            np.testing.assert_allclose(caches["blocks"][f"layer{i}"][key].numpy(),
                                       np.asarray(caches_r["blocks"][f"layer{i}"][key]),
                                       **MODEL_TOL)


def test_embed_scale_rounds_to_the_compute_type():
    """sqrt(d_model) is rounded to the compute type before the product, as
    the reference's ``jnp.asarray(math.sqrt(d), compute_dtype)``: 68.0 in
    bf16 for gemma2-27b's 4608."""
    pcfg = dataclasses.replace(PC.get_config("gemma2-27b"), n_layers=2)
    rcfg = dataclasses.replace(RC.get_config("gemma2-27b"), n_layers=2)
    embed = np.random.default_rng(3).standard_normal((4, pcfg.d_model)).astype(np.float32)
    tok = np.array([[0, 3, 1]], np.int32)
    got = PT._embed_tokens(pcfg, {"embed": _t(embed).to(torch.bfloat16)}, _t(tok))
    want = RT._embed_tokens(rcfg, {"embed": jnp.asarray(embed, jnp.bfloat16)},
                            jnp.asarray(tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    ratio = got.float() / _t(embed).to(torch.bfloat16).float()[tok[0]]
    assert float(torch.tensor(math.sqrt(4608), dtype=torch.bfloat16)) == 68.0
    assert torch.allclose(ratio, torch.full_like(ratio, 68.0), rtol=1e-2)


# -- the paged entries and the prefill at the zoo's grouped-query ratios -------------

ZOO_SCALE = 144 ** -0.5  # gemma2's query_pre_attn_scalar


def _paged_case(seed, t, cur, g, *, hkv=2, hd=128, bs=16, n_pages=9, b=4):
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_pages
    q = rng.standard_normal((b, t, hkv * g, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    kp[0] *= 100.0
    vp[0] *= 100.0
    pt = (rng.permutation(nb - 1)[: b * n_pages] + 1).reshape(b, n_pages)
    cl = np.asarray(cur, np.int32)
    for i in range(b):
        pt[i, (cl[i] + t - 1) // bs + 1:] = 0
    return q, kp, vp, pt.astype(np.int32), cl


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


ZOO_ATTN = [dict(), dict(softcap=50.0), dict(softcap=50.0, window=24)]


@pytest.mark.parametrize("attn", ZOO_ATTN, ids=str)
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("g", [2, 3, 6])
def test_paged_entries_at_zoo_groups_match_pallas(g, t, attn):
    """The plain paged entries (what the wrappers run on CPU tensors),
    full-precision and int8 pools, at g = H / Hkv of gemma2 (2), phi4-mini
    (3) and internlm2 (6), with gemma2's query scale."""
    from repro.kernels import quant as rquant
    q, kp, vp, pt, cl = _paged_case(10 * g + t, t, [139, 111, 88, 40], g)
    kw = dict(scale=ZOO_SCALE, **attn)
    if t == 1:
        q = q[:, 0]
        got = pops.paged_attention(*map(_t, (q, kp, vp, pt, cl)), **kw)
        want = rops.paged_attention(*map(jnp.asarray, (q, kp, vp, pt, cl)), **kw)
    else:
        got = pops.paged_attention_multi(*map(_t, (q, kp, vp, pt, cl)), **kw)
        want = rops.paged_attention_multi(*map(jnp.asarray, (q, kp, vp, pt, cl)), **kw)
    _close(got.numpy(), want, JAX_TOL)
    codes = []
    for pool in (kp, vp):
        s = rquant.scales_of(jnp.asarray(pool), "int8")
        codes.append((np.array(rquant.quantize(jnp.asarray(pool), s, "int8")), np.array(s)))
    (kc, ks), (vc, vs) = codes
    args = (q, kc, vc, ks, vs, pt, cl)
    fn, rfn = ((pops.paged_attention_quant, rops.paged_attention_quant) if t == 1 else
               (pops.paged_attention_multi_quant, rops.paged_attention_multi_quant))
    _close(fn(*map(_t, args), **kw).numpy(), rfn(*map(jnp.asarray, args), **kw), JAX_TOL)


@pytest.mark.parametrize("attn", ZOO_ATTN, ids=str)
@pytest.mark.parametrize("g", [2, 3, 6])
def test_prefill_at_zoo_groups_matches_reference(g, attn):
    """The plain prefill at q_offset 0 against the Pallas kernel (interpret
    mode; it has no q_offset) and at q_offset 32 against the reference
    model path's ``flash_attention_ref``."""
    from repro.models import attention as RA
    rng = np.random.default_rng(g)
    sq, hkv, hd = 32, 2, 128
    q = rng.standard_normal((1, sq, hkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((1, 2 * sq, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((1, 2 * sq, hkv, hd)).astype(np.float32)
    kw = dict(scale=ZOO_SCALE, **attn)
    got = pops.flash_attention(_t(q), _t(k[:, :sq]), _t(v[:, :sq]), **kw)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k[:, :sq]),
                                jnp.asarray(v[:, :sq]), block_q=16, block_k=16, **kw)
    _close(got.numpy(), want, JAX_TOL)
    got = pops.flash_attention(_t(q), _t(k), _t(v), q_offset=sq, **kw)
    want = RA.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16,
                                  q_offset=sq, window=attn.get("window", 0),
                                  softcap_val=attn.get("softcap", 0.0), scale=ZOO_SCALE)
    _close(got.numpy(), want, JAX_TOL)


# -- the engine ----------------------------------------------------------------------


def _prompts(vocab, tiled):
    rng = np.random.default_rng(7)
    if not tiled:
        return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    # prompt lookup proposes on prompts tiled from a short segment
    return [np.resize(rng.integers(0, vocab, 5), n).astype(np.int32) for n in LENS]


MODES = {"paged": dict(paged=True), "contiguous": dict(paged=False),
         "spec": dict(paged=True, spec_decode=True, spec_k=3),
         "int8": dict(paged=True, kv_dtype="int8")}
# every mode for the three configs; the softcapped gemma2 variant paged and
# contiguous (its softcaps act in the attention and the logits alike).
ENGINE_CASES = [("internlm2-20b", {}, list(MODES)), ("phi4-mini-3.8b", {}, list(MODES)),
                ("gemma2-27b", {}, list(MODES)),
                ("gemma2-27b", SOFTCAPPED, ["paged", "contiguous"])]


@pytest.mark.parametrize("arch,over,mode", [
    pytest.param(a, o, m, id=a + ("-softcapped" if o else "") + f"-{m}")
    for a, o, modes in ENGINE_CASES for m in modes])
def test_engine_matches_reference(arch, over, mode):
    rcfg, pcfg = _configs(arch, **over)
    tree = _numpy_params(rcfg)
    extra = MODES[mode]
    prompts = _prompts(rcfg.vocab_size, tiled=mode == "spec")
    ref = RS.StreamedBatchEngine(rcfg, _j(tree), RS.ServeConfig(**KW, **extra))
    r_uids = [ref.submit(p) for p in prompts]
    want = ref.run()
    eng = PS.StreamedBatchEngine(pcfg, bridge.params_from_numpy(tree, pcfg, device="cpu"),
                                 PS.ServeConfig(**KW, **extra), device="cpu")
    p_uids = [eng.submit(p) for p in prompts]
    got = eng.run()
    pairs = [(got[p], want[r]) for p, r in zip(p_uids, r_uids)]
    if mode == "int8":
        agree = np.mean([np.mean(a == b) for a, b in pairs])
        assert agree >= QUANT_FLOOR, agree
    else:
        for a, b in pairs:
            np.testing.assert_array_equal(a, b)
        assert eng.decode_steps == ref.decode_steps
    if mode == "spec":
        assert eng.spec_ticks > 0 and eng.spec_proposed > 0
        assert (eng.spec_ticks, eng.spec_accepted) == (ref.spec_ticks, ref.spec_accepted)
    if eng.paged:
        assert eng.kv.pages_in_use == 0
        eng.kv.check_invariants()


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--paged", "--spec-decode"]], ids=str)
@pytest.mark.parametrize("arch", ["internlm2-20b", "phi4-mini-3.8b", "gemma2-27b"])
def test_launcher_serves_the_dense_zoo_on_cpu(capsys, arch, flags):
    from repro_torch.launch import serve as pserve
    pserve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                 "--new-tokens", "4", "--prefill-chunk", "8", "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert "3 requests x 20 prompt -> 4 new tokens each" in out
    assert ("contiguous slot cache" in out) == ("--paged" not in flags)


@pytest.mark.parametrize("arch", RC.list_archs())
def test_check_supported_rejects_only_what_is_unported(arch):
    """Every reference config, built field by field into the port's
    ModelConfig at smoke size, is supported (the decoder-only attention
    stacks, mamba2, the jamba hybrid, whisper's encoder-decoder and
    paligemma's image prefix): it is in the port's registry, and the
    reference's parameters convert through the bridge with no leaf left
    over, shaped as the port's own init."""
    rcfg = RC.get_smoke_config(arch)
    fields = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)
              if f.name not in ("param_dtype", "compute_dtype", "layer_unit")}
    pcfg = PC.ModelConfig(**fields, param_dtype=torch.float32, compute_dtype=torch.float32,
                          layer_unit=tuple(PC.LayerSpec(**dataclasses.asdict(s))
                                           for s in rcfg.layer_unit))
    assert arch in PC.list_archs()
    PT.check_supported(pcfg)
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0)))
    params = bridge.params_from_numpy(tree, pcfg, device="cpu")
    fresh = PT.init_params(pcfg, 0, device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), fresh))[0])
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        assert flat[path].shape == a.shape, path
    assert all(v.dtype == (torch.float32) for v in jax.tree.leaves(params))

