"""Model configuration: the port's own copy of the reference dataclasses.

Field for field the same as ``repro.models.transformer.ModelConfig`` and
``LayerSpec`` (a test holds them equal), with torch dtypes in place of jnp
ones; ``ShapeSpec`` and ``SHAPES`` are the reference's assigned shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: The assigned LM shape set (same for all 10 archs; reference
#: ``configs/base.py``).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"  # "attn" | "attn_local" | "mamba" | "none"
    ffn: str = "dense"  # "dense" | "moe" | "none"
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    layer_unit: tuple[LayerSpec, ...] = (LayerSpec(),)

    # attention
    use_rope: bool = True
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0  # window for "attn_local" mixers (and mixtral SWA)
    query_scale: float | None = None  # None -> 1/sqrt(head_dim)
    sandwich_norm: bool = False  # gemma2 post-attn/post-ffn norms
    sinusoidal_pos: bool = False  # whisper-style absolute positions

    # ffn
    ffn_kind: str = "swiglu"  # "swiglu" | "geglu" | "gelu_mlp"

    # moe
    n_experts: int = 0
    top_k: int = 2
    expert_d_ff: int | None = None
    n_shared_experts: int = 0
    shared_d_ff: int | None = None
    capacity_factor: float = 1.25
    moe_chunk: int = 1024
    router_aux_coef: float = 0.01
    moe_impl: str = "gather"
    expert_shards: int = 1
    n_experts_pad: int | None = None

    # mamba
    ssm_state: int = 128
    mamba_headdim: int = 64
    mamba_expand: int = 2
    ssd_chunk: int = 64

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    # vlm (paligemma)
    prefix_len: int = 0

    # embeddings / head
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: h *= sqrt(d_model)
    vocab_pad_to: int = 256

    # compute
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    attn_chunk: int = 512
    loss_chunk: int = 512
    remat: str = "dots"
    scan_layers: bool = True

    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, self.vocab_pad_to
        return ((v + m - 1) // m) * m

    @property
    def n_repeats(self) -> int:
        if self.n_layers % len(self.layer_unit):
            raise ValueError(
                f"n_layers {self.n_layers} is not a multiple of the layer "
                f"unit ({len(self.layer_unit)})")
        return self.n_layers // len(self.layer_unit)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    def spec_window(self, spec: LayerSpec) -> int:
        return self.sliding_window if spec.mixer == "attn_local" else (
            self.sliding_window if self.sliding_window and all(
                s.mixer != "attn_local" for s in self.layer_unit) else 0)


def smoke_reduce(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Shrink a full config to a CPU-testable config of the same family
    (the reference's ``configs.base.smoke_reduce``, with torch dtypes)."""
    unit = cfg.layer_unit
    changes: dict[str, Any] = dict(
        n_layers=2 * len(unit),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        attn_chunk=16,
        loss_chunk=16,
        moe_chunk=16,
        ssd_chunk=8,
        remat="none",
    )
    if cfg.n_experts:
        changes.update(n_experts=4, top_k=min(cfg.top_k, 2), expert_d_ff=32,
                       n_shared_experts=min(cfg.n_shared_experts, 2) or 0,
                       shared_d_ff=64 if cfg.n_shared_experts else None)
    if any(s.mixer == "mamba" for s in unit):
        changes.update(ssm_state=16, mamba_headdim=8)
    if cfg.n_encoder_layers:
        changes.update(n_encoder_layers=2, encoder_seq=16)
    if cfg.prefix_len:
        changes.update(prefix_len=8)
    if cfg.sliding_window:
        changes.update(sliding_window=16)
    if cfg.query_scale is not None:
        changes.update(query_scale=1.0 / (changes["d_model"] / changes["n_heads"]) ** 0.5)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
