"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118; hf]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "gemma2-27b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    # alternating sliding-window (local) and full (global) attention
    layer_unit=(
        LayerSpec(mixer="attn_local", ffn="dense"),
        LayerSpec(mixer="attn", ffn="dense"),
    ),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    ffn_kind="geglu",
    rope_theta=1e4,
    # gemma2 query_pre_attn_scalar = d_model / n_heads = 144
    query_scale=(4608 / 32) ** -0.5,
    remat="full",
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = smoke_reduce(CONFIG)
