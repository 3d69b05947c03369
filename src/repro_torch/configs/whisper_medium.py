"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
— encoder-decoder; the conv frontend is a stub: requests carry precomputed
frame embeddings (encoder_seq=1500, d_model) [arXiv:2212.04356].

The decoder's self-attention has no rope: sinusoidal absolute positions
are added to the embeddings at prefill and decode.  Every decoder layer
cross-attends the request's encoder output, whose K/V are computed at
prefill and kept per slot.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "whisper-medium"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=24,  # decoder layers; the encoder has its own 24 below
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    layer_unit=(LayerSpec(mixer="attn", ffn="dense", cross_attn=True),),
    ffn_kind="gelu_mlp",
    use_rope=False,
    sinusoidal_pos=True,
    n_encoder_layers=24,
    encoder_seq=1500,
    tie_embeddings=True,
)

SMOKE = smoke_reduce(CONFIG)
