"""The layer stack of the served models (reference
``models/transformer.py``): init, the caches, the layer loop, the fused
prefill chunk, paged decode (one token, or a draft block for speculative
verify), the contiguous prefill chunk and decode steps (one token, or a
draft block), and greedy sampling.  Two layer kinds are ported: attention +
swiglu FFN (qwen3-4b) and the mamba2 block with no FFN (mamba2-2.7b).

Parameters are nested dicts of tensors laid out as the reference's pytree:
every leaf under ``blocks/layer{i}`` has a leading repeat axis ``r``, and a
Python loop over repeats takes the place of ``lax.scan``.  Attention pools
are ``(r, num_blocks, block_size, n_kv_heads, head_dim)`` per unit position
(plus ``(r, num_blocks, n_kv_heads)`` f32 scales when quantized), or
contiguous ``(r, B, s_cache, n_kv_heads, head_dim)`` rows per slot; mamba
layers carry slot-indexed ``ssm`` ``(r, B, H, P, N)`` f32 and ``conv``
``(r, B, 3, conv_dim)`` leaves.  Caches are updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import mamba

Params = dict


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for configs outside the ported layer
    kinds: decoder-only attention + swiglu stacks (qwen3-4b and its kin) and
    pure mamba2 stacks (mamba blocks, no FFN)."""
    for spec in cfg.layer_unit:
        attn = spec.mixer in ("attn", "attn_local") and spec.ffn == "dense"
        ssm = spec.mixer == "mamba" and spec.ffn == "none"
        if not (attn or ssm) or spec.cross_attn:
            raise NotImplementedError(
                f"layer {spec} is not ported yet: ROADMAP A10, the zoo "
                "(MoE, hybrids, encoder-decoder)")
    unsupported = [f for f in ("sandwich_norm", "sinusoidal_pos", "embed_scale",
                               "is_encoder_decoder", "prefix_len", "final_softcap")
                   if getattr(cfg, f)]
    if cfg.ffn_kind != "swiglu":
        unsupported.append(f"ffn_kind={cfg.ffn_kind}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet: ROADMAP "
            "A2 / A10 (the other nine configs)")


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------


def _mamba_kw(cfg: ModelConfig) -> dict:
    return dict(expand=cfg.mamba_expand, headdim=cfg.mamba_headdim, d_state=cfg.ssm_state)


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """Per-layer leaf shapes (no repeat axis), as the reference's pytree."""
    if spec.mixer == "mamba":
        return {"mixer_norm": {"scale": (cfg.d_model,)},
                "mixer": mamba.mamba_shapes(cfg.d_model, **_mamba_kw(cfg))}
    d, hd = cfg.d_model, cfg.head_dim
    mixer = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
             "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        mixer["q_norm"] = {"scale": (hd,)}
        mixer["k_norm"] = {"scale": (hd,)}
    return {"mixer_norm": {"scale": (d,)}, "mixer": mixer,
            "ffn_norm": {"scale": (d,)},
            "ffn": {"wi": (d, cfg.d_ff), "wg": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}}


def param_shapes(cfg: ModelConfig) -> dict:
    """Every leaf's shape, repeat axis included (the bridge checks against
    it)."""
    r = cfg.n_repeats

    def stack(tree):
        return {k: stack(v) if isinstance(v, dict) else (r, *v)
                for k, v in tree.items()}

    out = {"embed": (cfg.padded_vocab, cfg.d_model),
           "final_norm": {"scale": (cfg.d_model,)},
           "blocks": {f"layer{i}": stack(_layer_shapes(cfg, spec))
                      for i, spec in enumerate(cfg.layer_unit)}}
    if not cfg.tie_embeddings:
        out["unembed"] = (cfg.padded_vocab, cfg.d_model)
    return out


def leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The stored type of parameter leaf ``name``: ``cfg.param_dtype``, but
    f32 for mamba's A_log, D and dt_bias, as in the reference."""
    return torch.float32 if name in mamba.F32_PARAMS else cfg.param_dtype


def _layer_init(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator) -> Params:
    """One layer's parameters (no repeat axis), as the reference's
    ``_layer_init`` for an attention + dense FFN layer or a mamba layer."""
    dt, dev = cfg.param_dtype, gen.device
    if spec.mixer == "mamba":
        return {"mixer_norm": layers.rmsnorm_init(cfg.d_model, dt, dev),
                "mixer": mamba.mamba_init(gen, d_model=cfg.d_model, dtype=dt,
                                          **_mamba_kw(cfg))}
    return {
        "mixer_norm": layers.rmsnorm_init(cfg.d_model, dt, dev),
        "mixer": attn_lib.attention_init(
            gen, d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, dtype=dt,
            qk_norm=cfg.qk_norm),
        "ffn_norm": layers.rmsnorm_init(cfg.d_model, dt, dev),
        "ffn": layers.ffn_init(gen, cfg.d_model, cfg.d_ff, dt),
    }


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
    return p


def _slot_state(cfg: ModelConfig, bsz: int, dev) -> Params:
    """A mamba layer's slot-indexed state: ssm (r, B, H, P, N) f32 and the
    conv tail (r, B, 3, conv_dim) in ``compute_dtype``."""
    r = cfg.n_repeats
    c = mamba.mamba_cache_init(r * bsz, cfg.d_model, dtype=cfg.compute_dtype, device=dev,
                               **_mamba_kw(cfg))
    return {k: v.view(r, bsz, *v.shape[1:]) for k, v in c.items()}


def init_cache(cfg: ModelConfig, bsz: int, max_seq: int, *, ring: bool = True,
               device=None) -> Params:
    """Contiguous decode caches of ``bsz`` rows, stacked over the repeat
    axis per unit position (reference ``transformer.init_cache``):
    attention K/V ``(r, bsz, s_cache, n_kv_heads, head_dim)`` in
    ``compute_dtype``, where ``s_cache`` is ``max_seq`` or, for an SWA
    layer with ``ring=True``, ``min(window, max_seq)`` (a ring buffer; the
    streamed prefill needs ``ring=False``); mamba layers' slot-indexed
    state."""
    dev = resolve_device(device)
    blocks = {}
    for i, spec in enumerate(cfg.layer_unit):
        if spec.mixer == "mamba":
            blocks[f"layer{i}"] = _slot_state(cfg, bsz, dev)
            continue
        window = cfg.spec_window(spec)
        s_cache = min(window, max_seq) if (window > 0 and ring) else max_seq
        shape = (cfg.n_repeats, bsz, s_cache, cfg.n_kv_heads, cfg.head_dim)
        blocks[f"layer{i}"] = {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
                               "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}
    return {"blocks": blocks}


def init_paged_cache(cfg: ModelConfig, bsz: int, num_blocks: int, block_size: int,
                     kv_dtype: str = "fp32", *, device=None) -> Params:
    """One global page pool per attention unit position.  Block 0 is the
    trash page.  ``kv_dtype`` "fp32" keeps the pool in ``compute_dtype``;
    "int8" / "fp8" store codes plus ``k_scale``/``v_scale`` leaves of
    shape ``(r, num_blocks, n_kv_heads)`` f32 (see ``kernels/quant``).
    Mamba layers' state is O(1) per slot and stays slot-indexed (``bsz``
    rows), as in :func:`init_cache`.  An unknown ``kv_dtype`` raises
    ``ValueError``."""
    quantized = quant.is_quantized(kv_dtype)
    dev = resolve_device(device)
    pool_dt = quant.storage_dtype(kv_dtype) if quantized else cfg.compute_dtype
    shape = (cfg.n_repeats, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    sshape = (cfg.n_repeats, num_blocks, cfg.n_kv_heads)
    blocks = {}
    for i, spec in enumerate(cfg.layer_unit):
        if spec.mixer == "mamba":
            blocks[f"layer{i}"] = _slot_state(cfg, bsz, dev)
            continue
        c = {"k": torch.zeros(shape, dtype=pool_dt, device=dev),
             "v": torch.zeros(shape, dtype=pool_dt, device=dev)}
        if quantized:
            c["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
            c["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        blocks[f"layer{i}"] = c
    return {"blocks": blocks}


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------


def _at(tree: dict, i: int) -> dict:
    """The repeat-``i`` view of a stacked params or pool subtree."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Params, h: torch.Tensor, *,
                 positions, cache, cur_len, q_offset, page_table) -> torch.Tensor:
    """One layer (pre-norm, residual): attention + dense FFN, or a mamba
    block (decode when ``cur_len`` is given, else a prefill piece that
    continues from the cached state).  The cache views in ``cache`` are
    written in place."""
    if spec.mixer == "mamba":
        x = layers.rmsnorm(p["mixer_norm"], h)
        out, upd = mamba.mamba_apply(
            p["mixer"], x, chunk=cfg.ssd_chunk, state=cache["ssm"],
            conv_state=cache["conv"], decode=cur_len is not None, **_mamba_kw(cfg))
        cache["ssm"].copy_(upd["ssm"])
        cache["conv"].copy_(upd["conv"])
        return h + out
    window = cfg.spec_window(spec)
    x = layers.rmsnorm(p["mixer_norm"], h)
    out, _ = attn_lib.attention_apply(
        p["mixer"], x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions if cfg.use_rope else None,
        rope_theta=cfg.rope_theta, window=window, softcap_val=cfg.attn_softcap,
        scale=cfg.query_scale, qk_norm=cfg.qk_norm, cache=cache,
        cur_len=cur_len, q_offset=q_offset, page_table=page_table)
    h = h + out
    x = layers.rmsnorm(p["ffn_norm"], h)
    return h + layers.ffn_apply(p["ffn"], x)


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
) -> tuple[torch.Tensor, Params]:
    """Run the stacked blocks over the caches (updated in place)."""
    blocks, pools = params["blocks"], caches["blocks"]
    for i in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.layer_unit):
            name = f"layer{j}"
            h = _apply_layer(
                cfg, spec, _at(blocks[name], i), h, positions=positions,
                cache=_at(pools[name], i), cur_len=cur_len, q_offset=q_offset,
                page_table=page_table)
    return h, caches


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


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
    h, pools = forward_hidden(cfg, params, h, positions=positions, caches=pools,
                              page_table=page_table, q_offset=pos0)
    return _logits(cfg, params, h[:, -1:], unembed), pools


def decode_step_paged(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    page_table: torch.Tensor, cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) at per-slot positions ``cur_len``
    (B,).  Returns logits (B, 1, V) and the pools."""
    h = _embed_tokens(cfg, params, tokens)
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
    h, caches = forward_hidden(cfg, params, h, positions=positions, caches=caches,
                               page_table=page_table, cur_len=cur_len)
    return _logits(cfg, params, h, unembed), caches


def prefill_chunk(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params, pos0: int,
    *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """One prompt chunk at absolute positions ``pos0..`` over a contiguous
    cache (``init_cache``), continuing from the state it holds.  Returns
    the last position's logits (B, 1, V) and the caches."""
    h = _embed_tokens(cfg, params, tokens)
    positions = pos0 + torch.arange(h.shape[1], device=h.device)
    h, caches = forward_hidden(cfg, params, h, positions=positions, caches=caches,
                               q_offset=pos0)
    return _logits(cfg, params, h[:, -1:], unembed), caches


def decode_step(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """One decode step over a contiguous cache: tokens (B, 1) at per-slot
    positions ``cur_len`` (B,).  Returns logits (B, 1, V) and the caches."""
    h = _embed_tokens(cfg, params, tokens)
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
    h, caches = forward_hidden(cfg, params, h, positions=positions, caches=caches,
                               cur_len=cur_len)
    return _logits(cfg, params, h, unembed), caches


def decode_and_sample(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """Contiguous decode step with the greedy pick on the device: (B,) int32
    tokens and the caches."""
    logits, caches = decode_step(cfg, params, tokens, caches, cur_len, unembed=unembed)
    return sample_tokens(logits[:, -1]), caches


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy pick per row -> (B,) int32 (the first maximum, as jnp.argmax;
    temperature sampling is not ported yet)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_and_sample_paged(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, caches: Params,
    page_table: torch.Tensor, cur_len: torch.Tensor, *, unembed: torch.Tensor,
) -> tuple[torch.Tensor, Params]:
    """Paged decode step with the greedy pick on the device: returns (B,)
    int32 tokens, so a tick moves one int32 per slot to the host."""
    logits, caches = decode_step_paged(cfg, params, tokens, caches, page_table,
                                       cur_len, unembed=unembed)
    return sample_tokens(logits[:, -1]), caches
