"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216
— SigLIP + gemma [arXiv:2407.07726; hf].

The SigLIP vision tower is a stub: a request carries precomputed patch
embeddings (prefix_len=256, d_model), prepended to its text tokens with
prefix-LM masking (the image prefix attends bidirectionally).  Served only
through ``ServingEngine.generate(tokens, prefix_embeds=)``, as in the JAX
package.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

ARCH_ID = "paligemma-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    layer_unit=(LayerSpec(mixer="attn", ffn="dense"),),
    ffn_kind="geglu",
    rope_theta=1e4,
    prefix_len=256,  # SigLIP patch embeddings (stub)
    tie_embeddings=True,
    embed_scale=True,
    attn_chunk=256,  # must cover the bidirectional prefix and divide 4352
)

SMOKE = smoke_reduce(CONFIG)
