"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-4B]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "qwen3-4b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    layer_unit=(LayerSpec(mixer="attn", ffn="dense"),),
    ffn_kind="swiglu",
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
)

SMOKE = smoke_reduce(CONFIG)
