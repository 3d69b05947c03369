"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408 (per expert)
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "qwen2-moe-a2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert hidden
    expert_d_ff=1408,
    vocab_size=151936,
    layer_unit=(LayerSpec(mixer="attn", ffn="moe"),),
    n_experts=60,
    top_k=4,
    n_experts_pad=64,  # 4 dead slots, never routed to
    n_shared_experts=4,
    shared_d_ff=5632,  # 4 x 1408
    ffn_kind="swiglu",
    rope_theta=1e6,
    tie_embeddings=False,
)

SMOKE = smoke_reduce(CONFIG)
