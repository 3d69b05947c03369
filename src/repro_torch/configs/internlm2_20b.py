"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA [arXiv:2403.17297; hf]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "internlm2-20b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    layer_unit=(LayerSpec(mixer="attn", ffn="dense"),),
    ffn_kind="swiglu",
    rope_theta=1e6,
    remat="full",
    tie_embeddings=False,
)

SMOKE = smoke_reduce(CONFIG)
