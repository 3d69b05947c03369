"""mamba2-2.7b [ssm]: 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "mamba2-2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    layer_unit=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm_state=128,
    mamba_headdim=64,
    mamba_expand=2,
    ssd_chunk=256,
    use_rope=False,
    tie_embeddings=True,
)

SMOKE = smoke_reduce(CONFIG)
