"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "phi4-mini-3.8b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    layer_unit=(LayerSpec(mixer="attn", ffn="dense"),),
    ffn_kind="swiglu",
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = smoke_reduce(CONFIG)
