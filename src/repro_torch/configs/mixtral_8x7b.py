"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8e top-2 — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "mixtral-8x7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    expert_d_ff=14336,
    vocab_size=32000,
    layer_unit=(LayerSpec(mixer="attn", ffn="moe"),),
    n_experts=8,
    top_k=2,
    sliding_window=4096,  # no attn_local mixer: the window applies to every layer
    expert_shards=2,  # each expert stored as 2 half-width shards (E*2, D, F/2)
    ffn_kind="swiglu",
    rope_theta=1e6,
    remat="full",
    tie_embeddings=False,
)

SMOKE = smoke_reduce(CONFIG)
