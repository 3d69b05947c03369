"""The layer stack of the served models (reference
``models/transformer.py``): init, the caches, the layer loop, the fused
prefill chunk, paged decode (one token, or a draft block for speculative
verify), the contiguous prefill chunk and decode steps (one token, or a
draft block), and the on-device pick (greedy, or temperature sampling
keyed by request).  Every layer kind of the reference is ported: full or
sliding-window attention (gemma2 alternates them in a two-layer unit) or a
mamba2 block as the mixer (mamba2-2.7b: no FFN; jamba: mamba and
attention layers in one unit, each followed by a dense or MoE FFN), a
dense FFN (swiglu, geglu, gelu_mlp) or a MoE FFN (``models/moe.py``),
gemma2's sandwich norms, embedding scale and softcaps; whisper's encoder
(:func:`encode`, non-causal), its decoder's cross-attention block over the
request's encoder output and its sinusoidal positions; paligemma's image
prefix, prepended to the first prefill chunk and seen bidirectionally
(``prefix_len``).

Parameters are nested dicts of tensors laid out as the reference's pytree:
every leaf under ``blocks/layer{i}`` has a leading repeat axis ``r``, and a
Python loop over repeats takes the place of ``lax.scan``.  Attention pools
are ``(r, num_blocks, block_size, n_kv_heads, head_dim)`` per unit position
(plus ``(r, num_blocks, n_kv_heads)`` f32 scales when quantized), or
contiguous ``(r, B, s_cache, n_kv_heads, head_dim)`` rows per slot; mamba
layers carry slot-indexed ``ssm`` ``(r, B, H, P, N)`` f32 and ``conv``
``(r, B, 3, conv_dim)`` leaves, cross-attention layers slot-indexed
``cross_k`` / ``cross_v`` ``(r, B, encoder_seq, n_kv_heads, head_dim)``
(written at prefill, read at decode).  Caches are updated in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import quant
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import mamba
from repro_torch.models import moe
from repro_torch.runtime import sampling

Params = dict


MIXERS = ("attn", "attn_local", "mamba", "none")
FFNS = ("dense", "moe", "none")
#: The encoder's layer unit (whisper): attention, then a gelu_mlp FFN.
ENC_UNIT = (LayerSpec(mixer="attn", ffn="dense"),)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a layer kind the reference does
    not have either (every reference config passes)."""
    for spec in cfg.layer_unit:
        if spec.mixer not in MIXERS:
            raise NotImplementedError(f"{cfg.name}: mixer {spec.mixer!r} is not ported")
        if spec.ffn not in FFNS:
            raise NotImplementedError(f"{cfg.name}: ffn {spec.ffn!r} is not ported")


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------


def _mamba_kw(cfg: ModelConfig) -> dict:
    return dict(expand=cfg.mamba_expand, headdim=cfg.mamba_headdim, d_state=cfg.ssm_state)


def _moe_kw(cfg: ModelConfig) -> dict:
    return dict(d_model=cfg.d_model, d_ff=cfg.expert_d_ff or cfg.d_ff,
                n_experts=cfg.n_experts, n_shared_experts=cfg.n_shared_experts,
                shared_d_ff=cfg.shared_d_ff, expert_shards=cfg.expert_shards,
                n_experts_pad=cfg.n_experts_pad)


def _attn_shapes(cfg: ModelConfig, *, qk_norm: bool) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    out = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
           "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if qk_norm:
        out["q_norm"] = {"scale": (hd,)}
        out["k_norm"] = {"scale": (hd,)}
    return out


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """Per-layer leaf shapes (no repeat axis), as the reference's pytree:
    the mixer (attention with its sandwich norm, or mamba), the
    cross-attention block, then the FFN (dense with its sandwich norm, or
    MoE)."""
    d = cfg.d_model
    out: dict = {}
    if spec.mixer in ("attn", "attn_local"):
        out["mixer_norm"] = {"scale": (d,)}
        out["mixer"] = _attn_shapes(cfg, qk_norm=cfg.qk_norm)
        if cfg.sandwich_norm:
            out["post_mixer_norm"] = {"scale": (d,)}
    elif spec.mixer == "mamba":
        out["mixer_norm"] = {"scale": (d,)}
        out["mixer"] = mamba.mamba_shapes(d, **_mamba_kw(cfg))
    if spec.cross_attn:
        out["cross_norm"] = {"scale": (d,)}
        out["cross"] = _attn_shapes(cfg, qk_norm=False)
    if spec.ffn == "dense":
        out["ffn_norm"] = {"scale": (d,)}
        out["ffn"] = {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
        if cfg.ffn_kind != "gelu_mlp":
            out["ffn"]["wg"] = (d, cfg.d_ff)
        if cfg.sandwich_norm:
            out["post_ffn_norm"] = {"scale": (d,)}
    elif spec.ffn == "moe":
        out["ffn_norm"] = {"scale": (d,)}
        out["ffn"] = moe.moe_shapes(**_moe_kw(cfg))
    return out


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's view of the config (reference ``encode``): gelu_mlp
    FFNs, no rope."""
    return dataclasses.replace(cfg, ffn_kind="gelu_mlp", use_rope=False)


def param_shapes(cfg: ModelConfig) -> dict:
    """Every leaf's shape, repeat axis included (the bridge checks against
    it)."""
    def stack(tree, r):
        return {k: stack(v, r) if isinstance(v, dict) else (r, *v)
                for k, v in tree.items()}

    out = {"embed": (cfg.padded_vocab, cfg.d_model),
           "final_norm": {"scale": (cfg.d_model,)},
           "blocks": {f"layer{i}": stack(_layer_shapes(cfg, spec), cfg.n_repeats)
                      for i, spec in enumerate(cfg.layer_unit)}}
    if not cfg.tie_embeddings:
        out["unembed"] = (cfg.padded_vocab, cfg.d_model)
    if cfg.is_encoder_decoder:
        out["encoder"] = {
            "blocks": {f"layer{i}": stack(_layer_shapes(_enc_cfg(cfg), spec),
                                          cfg.n_encoder_layers)
                       for i, spec in enumerate(ENC_UNIT)},
            "final_norm": {"scale": (cfg.d_model,)}}
    return out


#: Leaves stored in f32 whatever ``param_dtype`` is.
F32_PARAMS = (*mamba.F32_PARAMS, "router")


def leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The stored type of parameter leaf ``name``: ``cfg.param_dtype``, but
    f32 for mamba's A_log, D and dt_bias and the MoE router, as in the
    reference."""
    return torch.float32 if name in F32_PARAMS else cfg.param_dtype


def _layer_init(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator) -> Params:
    """One layer's parameters (no repeat axis), as the reference's
    ``_layer_init``: the mixer, the cross-attention block, the FFN."""
    dt, dev = cfg.param_dtype, gen.device
    p: Params = {}
    if spec.mixer in ("attn", "attn_local"):
        p["mixer_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["mixer"] = attn_lib.attention_init(
            gen, d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, dtype=dt, qk_norm=cfg.qk_norm)
        if cfg.sandwich_norm:
            p["post_mixer_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
    elif spec.mixer == "mamba":
        p["mixer_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["mixer"] = mamba.mamba_init(gen, d_model=cfg.d_model, dtype=dt, **_mamba_kw(cfg))
    if spec.cross_attn:
        p["cross_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["cross"] = attn_lib.attention_init(
            gen, d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, dtype=dt)
    if spec.ffn == "dense":
        p["ffn_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["ffn"] = layers.ffn_init(gen, cfg.d_model, cfg.d_ff, dt, kind=cfg.ffn_kind)
        if cfg.sandwich_norm:
            p["post_ffn_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
    elif spec.ffn == "moe":
        p["ffn_norm"] = layers.rmsnorm_init(cfg.d_model, dt, dev)
        p["ffn"] = moe.moe_init(gen, dtype=dt, **_moe_kw(cfg))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0, *,
                device=None) -> Params:
    """The reference's distributions: truncated-normal fan-in matrices,
    N(0, 0.02) embeddings, zero rmsnorm scales.  Drawn from ``generator``
    (or a generator seeded with it, on ``device``), directly on the device.
    Each repeat's layer is drawn alone and copied into the stacked leaves,
    so only one layer's temporaries exist at a time."""
    check_supported(cfg)
    if isinstance(generator, torch.Generator):
        gen = generator
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(generator))
    dev, dt = gen.device, cfg.param_dtype
    shapes = param_shapes(cfg)

    def empty(tree):
        return {k: empty(v) if isinstance(v, dict)
                else torch.empty(v, dtype=leaf_dtype(cfg, k), device=dev)
                for k, v in tree.items()}

    def copy_into(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                copy_into(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    p: Params = {"embed": layers.embed_init(gen, shapes["embed"], dt),
                 "final_norm": layers.rmsnorm_init(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        p["unembed"] = layers.embed_init(gen, shapes["unembed"], dt)
    p["blocks"] = empty(shapes["blocks"])
    for i in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.layer_unit):
            copy_into(p["blocks"][f"layer{j}"], _layer_init(cfg, spec, gen), i)
    if cfg.is_encoder_decoder:
        enc_cfg = _enc_cfg(cfg)
        p["encoder"] = {"blocks": empty(shapes["encoder"]["blocks"]),
                        "final_norm": layers.rmsnorm_init(cfg.d_model, dt, dev)}
        for i in range(cfg.n_encoder_layers):
            for j, spec in enumerate(ENC_UNIT):
                copy_into(p["encoder"]["blocks"][f"layer{j}"],
                          _layer_init(enc_cfg, spec, gen), i)
    return p


def _slot_state(cfg: ModelConfig, bsz: int, dev) -> Params:
    """A mamba layer's slot-indexed state: ssm (r, B, H, P, N) f32 and the
    conv tail (r, B, 3, conv_dim) in ``compute_dtype``."""
    r = cfg.n_repeats
    c = mamba.mamba_cache_init(r * bsz, cfg.d_model, dtype=cfg.compute_dtype, device=dev,
                               **_mamba_kw(cfg))
    return {k: v.view(r, bsz, *v.shape[1:]) for k, v in c.items()}


def _cross_state(cfg: ModelConfig, bsz: int, dev) -> Params:
    """A cross-attention layer's slot-indexed encoder K/V: ``cross_k`` /
    ``cross_v`` (r, B, encoder_seq, n_kv_heads, head_dim) in
    ``compute_dtype``, written by the prefill, read by decode."""
    shape = (cfg.n_repeats, bsz, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "cross_v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def init_cache(cfg: ModelConfig, bsz: int, max_seq: int, *, ring: bool = True,
               device=None) -> Params:
    """Contiguous decode caches of ``bsz`` rows, stacked over the repeat
    axis per unit position (reference ``transformer.init_cache``):
    attention K/V ``(r, bsz, s_cache, n_kv_heads, head_dim)`` in
    ``compute_dtype``, where ``s_cache`` is ``max_seq`` or, for an SWA
    layer with ``ring=True``, ``min(window, max_seq)`` (a ring buffer; the
    streamed prefill needs ``ring=False``); mamba layers' slot-indexed
    state; cross-attention layers' slot-indexed encoder K/V."""
    dev = resolve_device(device)
    blocks = {}
    for i, spec in enumerate(cfg.layer_unit):
        c: Params = {}
        if spec.mixer in ("attn", "attn_local"):
            window = cfg.spec_window(spec)
            s_cache = min(window, max_seq) if (window > 0 and ring) else max_seq
            shape = (cfg.n_repeats, bsz, s_cache, cfg.n_kv_heads, cfg.head_dim)
            c["k"] = torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
            c["v"] = torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
        elif spec.mixer == "mamba":
            c.update(_slot_state(cfg, bsz, dev))
        if spec.cross_attn:
            c.update(_cross_state(cfg, bsz, dev))
        blocks[f"layer{i}"] = c
    return {"blocks": blocks}


def init_paged_cache(cfg: ModelConfig, bsz: int, num_blocks: int, block_size: int,
                     kv_dtype: str = "fp32", *, device=None) -> Params:
    """One global page pool per attention unit position.  Block 0 is the
    trash page.  ``kv_dtype`` "fp32" keeps the pool in ``compute_dtype``;
    "int8" / "fp8" store codes plus ``k_scale``/``v_scale`` leaves of
    shape ``(r, num_blocks, n_kv_heads)`` f32 (see ``kernels/quant``).
    Mamba layers' state is O(1) per slot and stays slot-indexed (``bsz``
    rows), as in :func:`init_cache`; so do cross-attention K/V, fixed at
    ``encoder_seq`` rows a slot.  An unknown ``kv_dtype`` raises
    ``ValueError``."""
    quantized = quant.is_quantized(kv_dtype)
    dev = resolve_device(device)
    pool_dt = quant.storage_dtype(kv_dtype) if quantized else cfg.compute_dtype
    shape = (cfg.n_repeats, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    sshape = (cfg.n_repeats, num_blocks, cfg.n_kv_heads)
    blocks = {}
    for i, spec in enumerate(cfg.layer_unit):
        c: Params = {}
        if spec.mixer in ("attn", "attn_local"):
            c["k"] = torch.zeros(shape, dtype=pool_dt, device=dev)
            c["v"] = torch.zeros(shape, dtype=pool_dt, device=dev)
            if quantized:
                c["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
                c["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        elif spec.mixer == "mamba":
            c.update(_slot_state(cfg, bsz, dev))
        if spec.cross_attn:
            c.update(_cross_state(cfg, bsz, dev))
        blocks[f"layer{i}"] = c
    return {"blocks": blocks}


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------


def _at(tree: dict, i: int) -> dict:
    """The repeat-``i`` view of a stacked params or pool subtree."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


_KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Params, h: torch.Tensor, *,
                 positions, cache, cur_len, q_offset, page_table, enc_out=None,
                 prefix_len: int = 0, causal: bool = True) -> torch.Tensor:
    """One layer (pre-norm, residual): the mixer -- attention (with
    sandwich norms, its output normed before the residual add) or a mamba
    block (decode when ``cur_len`` is given, else a prefill piece that
    continues from the cached state) --, then the cross-attention block,
    then a dense or MoE FFN (the MoE aux loss is dropped, as serving drops
    it).  The cache views in ``cache`` (None: no cache, as the encoder) are
    written in place."""
    if spec.mixer in ("attn", "attn_local"):
        kv = (None if cache is None or "k" not in cache
              else {k: cache[k] for k in _KV_LEAVES if k in cache})
        x = layers.rmsnorm(p["mixer_norm"], h)
        out, _ = attn_lib.attention_apply(
            p["mixer"], x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions if cfg.use_rope else None,
            rope_theta=cfg.rope_theta, causal=causal, window=cfg.spec_window(spec),
            prefix_len=prefix_len, softcap_val=cfg.attn_softcap, scale=cfg.query_scale,
            qk_norm=cfg.qk_norm, cache=kv, cur_len=cur_len, q_offset=q_offset,
            page_table=page_table)
        if cfg.sandwich_norm:
            out = layers.rmsnorm(p["post_mixer_norm"], out)
        h = h + out
    elif spec.mixer == "mamba":
        x = layers.rmsnorm(p["mixer_norm"], h)
        out, upd = mamba.mamba_apply(
            p["mixer"], x, chunk=cfg.ssd_chunk,
            state=cache["ssm"] if cache is not None else None,
            conv_state=cache["conv"] if cache is not None else None,
            decode=cur_len is not None, **_mamba_kw(cfg))
        if cache is not None:
            cache["ssm"].copy_(upd["ssm"])
            cache["conv"].copy_(upd["conv"])
        h = h + out
    if spec.cross_attn:
        h = h + _cross_attend(cfg, p, h, cache=cache, cur_len=cur_len, enc_out=enc_out)
    if spec.ffn == "dense":
        x = layers.rmsnorm(p["ffn_norm"], h)
        out = layers.ffn_apply(p["ffn"], x, kind=cfg.ffn_kind)
        if cfg.sandwich_norm:
            out = layers.rmsnorm(p["post_ffn_norm"], out)
        h = h + out
    elif spec.ffn == "moe":
        x = layers.rmsnorm(p["ffn_norm"], h)
        out, _ = moe.moe_apply(p["ffn"], x, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor, moe_chunk=cfg.moe_chunk,
                               impl=cfg.moe_impl, expert_shards=cfg.expert_shards)
        h = h + out
    return h


def _cross_attend(cfg: ModelConfig, p: Params, h: torch.Tensor, *, cache, cur_len,
                  enc_out) -> torch.Tensor:
    """The cross-attention block's output (reference ``_apply_layer``'s
    ``cross_attn`` branch), before the residual add.  Prefill: the encoder
    output's K/V (``enc_out`` given: computed and stored into the slot's
    ``cross_k`` / ``cross_v``; else, a later chunk of the prompt, the ones
    the first chunk stored), attended without a mask by the prefill kernel.
    Decode: the stored K/V, every frame visible, by torch ops
    (:func:`attention.decode_attention`, as the reference's jnp)."""
    x = layers.rmsnorm(p["cross_norm"], h)
    b, s, _ = x.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["cross"]["wq"]).reshape(b, s, cfg.n_heads, hd)
    stored = cache is not None and "cross_k" in cache
    if cur_len is not None and stored:
        kc, vc = cache["cross_k"], cache["cross_v"]
        # Every encoder frame is visible: the last frame's position.
        last = torch.full((b,), kc.shape[1] - 1, dtype=torch.long, device=q.device)
        out = attn_lib.decode_attention(q, kc, vc, cur_len=last)
    else:
        if enc_out is not None:
            es = enc_out.shape[1]
            kc = (enc_out @ p["cross"]["wk"]).reshape(b, es, hkv, hd)
            vc = (enc_out @ p["cross"]["wv"]).reshape(b, es, hkv, hd)
            if stored:
                cache["cross_k"].copy_(kc)
                cache["cross_v"].copy_(vc)
        elif stored:
            kc, vc = cache["cross_k"], cache["cross_v"]
        else:
            raise ValueError(f"{cfg.name}: cross-attention needs enc_out or stored K/V")
        out = ops.flash_attention(q.contiguous(), kc.contiguous(), vc.contiguous(),
                                  causal=False)
    return out.reshape(b, s, cfg.n_heads * hd) @ p["cross"]["wo"]


def forward_hidden(
    cfg: ModelConfig,
    params: Params,
    h: torch.Tensor,  # (B, S, D) embedded inputs
    *,
    positions: torch.Tensor,
    caches: Params,  # paged pools or contiguous slot state, stacked over repeats
    page_table: torch.Tensor | None = None,  # (B, n_pages) int32, shared by every layer
    cur_len: torch.Tensor | None = None,  # decode: (B,) int32
    q_offset: int = 0,
    enc_out: torch.Tensor | None = None,  # (B, encoder_seq, D): the first chunk's
    prefix_len: int = 0,  # the first chunk's bidirectional image prefix
) -> tuple[torch.Tensor, Params]:
    """Run the stacked blocks over the caches (updated in place)."""
    blocks, pools = params["blocks"], caches["blocks"]
    for i in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.layer_unit):
            name = f"layer{j}"
            h = _apply_layer(
                cfg, spec, _at(blocks[name], i), h, positions=positions,
                cache=_at(pools[name], i), cur_len=cur_len, q_offset=q_offset,
                page_table=page_table, enc_out=enc_out, prefix_len=prefix_len)
    return h, caches


def encode(cfg: ModelConfig, params: Params, enc_inputs: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings (B, encoder_seq,
    D): sinusoidal positions, ``n_encoder_layers`` non-causal attention +
    gelu_mlp layers, the final norm (reference ``encode``).  Returns (B,
    encoder_seq, D) in ``compute_dtype``."""
    h = enc_inputs.to(cfg.compute_dtype)
    h = h + layers.sinusoidal_positions(h.shape[1], cfg.d_model, cfg.compute_dtype,
                                        device=h.device)[None]
    enc_cfg, enc = _enc_cfg(cfg), params["encoder"]
    for i in range(cfg.n_encoder_layers):
        for j, spec in enumerate(ENC_UNIT):
            h = _apply_layer(enc_cfg, spec, _at(enc["blocks"][f"layer{j}"], i), h,
                             positions=None, cache=None, cur_len=None, q_offset=0,
                             page_table=None, causal=False)
    return layers.rmsnorm(enc["final_norm"], h)


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows in ``compute_dtype``; with ``embed_scale`` (gemma)
    times sqrt(d_model) first rounded to ``compute_dtype``, as the
    reference's ``jnp.asarray(math.sqrt(d), compute_dtype)`` (bf16: 68.0
    for sqrt(4608) = 67.88)."""
    return _scaled(cfg, params["embed"][tokens.long()].to(cfg.compute_dtype))


def _scaled(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.embed_scale:  # rounded on the host: no copy inside a captured step
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype))
    return h


def _add_positions(cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Whisper's sinusoidal embeddings at ``positions`` ((S,) at prefill,
    (B, T) at decode, on the device); a no-op for rope / NoPE configs."""
    if not cfg.sinusoidal_pos:
        return h
    return h + layers.sinusoidal_positions_at(positions, cfg.d_model, cfg.compute_dtype)


def _unembed(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def unembed_f32(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The (padded_vocab, D) output matrix in f32.  Made once and handed to
    the steps: casting the full table every tick would copy it every tick
    (a no-op for f32 params, which it returns as they are)."""
    return _unembed(cfg, params).float()


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
            unembed: torch.Tensor) -> torch.Tensor:
    """f32 logits over the padded vocabulary (padded rows included, as the
    reference's argmax sees them); ``unembed`` is ``unembed_f32``'s table."""
    h = layers.rmsnorm(params["final_norm"], h)
    return layers.softcap(h.float() @ unembed.T, cfg.final_softcap)


def prefill_chunk_paged(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, pools: Params,
    page_table: torch.Tensor, pos0: int, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """One prompt chunk at absolute positions ``pos0..``: its K/V go straight
    into the pool blocks of ``page_table`` (which covers the context so
    far), attention reads the context back through the table.  Returns the
    last position's logits (B, 1, V) and the pools."""
    h = _embed_tokens(cfg, params, tokens)
    positions = pos0 + torch.arange(h.shape[1], device=h.device)
    h = _add_positions(cfg, h, positions)
    h, pools = forward_hidden(cfg, params, h, positions=positions, caches=pools,
                              page_table=page_table, q_offset=pos0)
    return _logits(cfg, params, h[:, -1:], unembed), pools


def decode_step_paged(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    page_table: torch.Tensor, cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) at per-slot positions ``cur_len``
    (B,).  Returns logits (B, 1, V) and the pools."""
    h = _add_positions(cfg, _embed_tokens(cfg, params, tokens), cur_len[:, None])
    h, caches = forward_hidden(cfg, params, h, positions=cur_len[:, None],
                               caches=caches, page_table=page_table,
                               cur_len=cur_len)
    return _logits(cfg, params, h, unembed), caches


def decode_step_multi_paged(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    page_table: torch.Tensor, cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """Multi-token decode step (the speculative verify step's target pass):
    tokens (B, T) at positions ``cur_len + [0, T)``, each written into the
    pool and scored with a causal mask inside the block.  Positions past a
    row's pages (padding past its live draft) go to trash block 0.  Returns
    logits (B, T, V) and the pools."""
    h = _embed_tokens(cfg, params, tokens)
    positions = cur_len.long()[:, None] + torch.arange(tokens.shape[1], device=h.device)
    h = _add_positions(cfg, h, positions)
    h, caches = forward_hidden(cfg, params, h, positions=positions, caches=caches,
                               page_table=page_table, cur_len=cur_len)
    return _logits(cfg, params, h, unembed), caches


def prefill_chunk(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params, pos0: int,
    *, unembed: torch.Tensor, enc_out: torch.Tensor | None = None,
    prefix: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """One prompt chunk at absolute positions ``pos0..`` over a contiguous
    cache (``init_cache``), continuing from the state it holds.  The first
    chunk of a whisper prompt carries ``enc_out`` (B, encoder_seq, D), whose
    cross K/V it stores; the first chunk of a paligemma prompt carries the
    image ``prefix`` (B, prefix_len, D), scaled as the embeddings, put
    before the tokens and seen bidirectionally.  Returns the last
    position's logits (B, 1, V) and the caches."""
    h = _embed_tokens(cfg, params, tokens)
    prefix_len = 0
    if prefix is not None:
        h = torch.cat([_scaled(cfg, prefix.to(cfg.compute_dtype)), h], dim=1)
        prefix_len = cfg.prefix_len
    positions = pos0 + torch.arange(h.shape[1], device=h.device)
    h = _add_positions(cfg, h, positions)
    h, caches = forward_hidden(cfg, params, h, positions=positions, caches=caches,
                               q_offset=pos0, enc_out=enc_out, prefix_len=prefix_len)
    return _logits(cfg, params, h[:, -1:], unembed), caches


def decode_step(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """One decode step over a contiguous cache: tokens (B, 1) at per-slot
    positions ``cur_len`` (B,).  Returns logits (B, 1, V) and the caches."""
    h = _add_positions(cfg, _embed_tokens(cfg, params, tokens), cur_len[:, None])
    h, caches = forward_hidden(cfg, params, h, positions=cur_len[:, None], caches=caches,
                               cur_len=cur_len)
    return _logits(cfg, params, h, unembed), caches


def _multi_unit_check(cfg: ModelConfig, caches: Params) -> None:
    """The reference's guards on the multi-token step: mamba state cannot
    roll back, and a draft block scattered into an SWA ring would overwrite
    committed keys before acceptance is known."""
    if any(spec.mixer == "mamba" for spec in cfg.layer_unit):
        raise NotImplementedError(
            "multi-token decode rolls rejected KV writes back by masking; "
            "mamba/hybrid archs advance irreversible per-slot SSM state")
    for i, spec in enumerate(cfg.layer_unit):
        c = caches["blocks"].get(f"layer{i}", {})
        window = cfg.spec_window(spec)
        if window > 0 and "k" in c and c["k"].shape[2] == window:
            raise NotImplementedError(
                "multi-token decode needs full-length caches (init_cache ring=False): "
                "scattering a draft block into a ring buffer overwrites committed keys "
                "before acceptance is known")


def decode_step_multi(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """Multi-token decode step over a contiguous cache (the contiguous
    verify step's target pass): tokens (B, T) at positions ``cur_len +
    [0, T)``, each written at its position and scored with a causal mask
    inside the block.  Positions at or past the cache length (padding past
    a slot's live draft) are dropped; rows past a slot's accepted prefix
    stay invisible (masked by ``cur_len``) until decode overwrites them.
    Returns logits (B, T, V) and the caches."""
    _multi_unit_check(cfg, caches)
    h = _embed_tokens(cfg, params, tokens)
    positions = cur_len.long()[:, None] + torch.arange(tokens.shape[1], device=h.device)
    h = _add_positions(cfg, h, positions)
    h, caches = forward_hidden(cfg, params, h, positions=positions, caches=caches,
                               cur_len=cur_len)
    return _logits(cfg, params, h, unembed), caches


def decode_and_sample(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    cur_len: torch.Tensor, *, unembed: torch.Tensor, temperature: float = 0.0,
    uids: torch.Tensor | None = None, steps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """Contiguous decode step with the pick on the device (see
    :func:`sample_tokens`): (B,) int32 tokens and the caches."""
    logits, caches = decode_step(cfg, params, tokens, caches, cur_len, unembed=unembed)
    return sample_tokens(logits[:, -1], temperature=temperature, uids=uids,
                         steps=steps), caches


def sample_tokens(logits: torch.Tensor, *, temperature: float = 0.0,
                  uids: torch.Tensor | None = None,
                  steps: torch.Tensor | None = None) -> torch.Tensor:
    """The next token per row of ``logits`` (B, V) -> (B,) int32.  Greedy
    when ``temperature`` is 0: the first maximum, as jnp.argmax.  Else row
    b draws from ``softmax(logits / temperature)`` with the stream of
    request ``uids[b]`` at its ``steps[b]``-th token
    (``runtime.sampling``), so its draw depends on nothing else in the
    batch."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if uids is None or steps is None:
        raise ValueError("temperature sampling needs the rows' uids and steps")
    return sampling.gumbel_pick(logits, temperature, sampling.stream_keys(uids, steps))


def decode_and_sample_paged(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    page_table: torch.Tensor, cur_len: torch.Tensor, *, unembed: torch.Tensor,
    temperature: float = 0.0, uids: torch.Tensor | None = None,
    steps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """Paged decode step with the pick on the device: returns (B,) int32
    tokens, so a tick moves one int32 per slot to the host."""
    logits, caches = decode_step_paged(cfg, params, tokens, caches, page_table,
                                       cur_len, unembed=unembed)
    return sample_tokens(logits[:, -1], temperature=temperature, uids=uids,
                         steps=steps), caches
