"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Layer unit (8 layers, repeated 9x): attention at index 3, all others Mamba;
MoE replaces the dense MLP on every other layer (odd indices) -> 4 MoE
layers per unit, 36 total.  Attention layers carry no positional encoding
(the Mamba layers provide position information).  The mixer is the
Mamba2/SSD block where the original uses Mamba-1, as in the JAX package.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce


def _unit() -> tuple[LayerSpec, ...]:
    specs = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(specs)


ARCH_ID = "jamba-1.5-large-398b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    expert_d_ff=24576,
    vocab_size=65536,
    layer_unit=_unit(),
    n_experts=16,
    top_k=2,
    ssm_state=128,
    mamba_headdim=128,
    mamba_expand=2,
    ssd_chunk=256,
    ffn_kind="swiglu",
    use_rope=False,  # no positional encoding on attention layers
    remat="full",
    tie_embeddings=False,
)

SMOKE = smoke_reduce(CONFIG, mamba_headdim=8)
