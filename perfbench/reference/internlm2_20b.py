"""Plain PyTorch reference of InternLM2 (arXiv:2403.17297; the
``InternLM2ForCausalLM`` of internlm/internlm2-20b), in float32 with TF32
off, for the benchmark's check.  It imports nothing of the program.

The architecture, as published: token embedding; per layer a pre-norm
RMSNorm, grouped-query attention (query head ``i`` reads key/value head
``i // (heads / kv_heads)``) with rotary positions (``rotate_half``, base
``rope_theta``) and a causal softmax scaled by ``1 / sqrt(head_dim)``, a
residual add, a pre-norm RMSNorm, a SwiGLU FFN (``w2(silu(w1 x) * w3
x)``), a residual add; a final RMSNorm and an untied output matrix.  No
biases.

The weights are the harness's seeded tensors, as the program is handed
them: matrices stored ``(in, out)`` and stacked over the layers under
``blocks/layer0``; an RMSNorm's gain is ``1 + scale``; ``wq``/``wk``/
``wv`` are InternLM2's packed ``wqkv`` unpacked per kind (with random
weights the packing order is a relabelling), ``ffn.wg``/``ffn.wi``/
``ffn.wo`` its ``w1``/``w3``/``w2``.  The output matrix has as many rows
as the harness gave it (the program pads the vocabulary), and every row is
scored.  Departures from the published model, taken from the
configuration file as run: ``rms_norm_eps``.

``fp8=True`` is the benchmark's control: every product with a weight
matrix (and the output matrix) takes its operands rounded to float8 e4m3
(a scale per row of the activations and per output column of the
weights), products summed in float32.
"""

from __future__ import annotations

import math

import torch

Q_BLOCK = 1024  # query rows a block of the attention


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (S, in) @ w (in, out) in float32, or over fp8-rounded operands."""
    if fp8:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd): HF's ``x * cos + rotate_half(x) * sin``."""
    s, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k/v (S, Hkv, hd) -> (S, H * hd)."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # (H, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty_like(q)
    for lo in range(0, s, Q_BLOCK):
        hi = min(s, lo + Q_BLOCK)
        sc = q[:, lo:hi] @ k[:, :hi].transpose(1, 2)  # (H, n, hi)
        mask = (torch.arange(lo, hi, device=q.device)[:, None]
                >= torch.arange(hi, device=q.device)[None])
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, lo:hi] = torch.softmax(sc, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1).reshape(s, h * hd)


@torch.no_grad()
def logits(model: dict, params: dict, seqs: list, starts: list[int], *,
           device, fp8: bool = False) -> list[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (ints), the float32 logits at
    positions ``starts[i]`` to its end: (len - start, rows of the output
    matrix), on ``device``.  Runs layer by layer over all the sequences,
    one layer's weights in float32 at a time."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps, theta = model["rms_norm_eps"], model["rope_theta"]
        h_heads, kv, hd = (model["num_attention_heads"], model["num_key_value_heads"],
                           model["head_dim"])
        blocks = params["blocks"]["layer0"]
        toks = [torch.as_tensor(s, dtype=torch.long, device=device) for s in seqs]
        hs = [params["embed"][t].float() for t in toks]
        for li in range(model["num_hidden_layers"]):
            w = {k: blocks["mixer"][k][li].float() for k in ("wq", "wk", "wv", "wo")}
            w.update({f"f_{k}": blocks["ffn"][k][li].float() for k in ("wi", "wg", "wo")})
            n1, n2 = blocks["mixer_norm"]["scale"][li], blocks["ffn_norm"]["scale"][li]
            for i, h in enumerate(hs):
                s = h.shape[0]
                x = _rmsnorm(h, n1, eps)
                q = _rope(_mm(x, w["wq"], fp8).view(s, h_heads, hd), theta)
                k = _rope(_mm(x, w["wk"], fp8).view(s, kv, hd), theta)
                v = _mm(x, w["wv"], fp8).view(s, kv, hd)
                h = h + _mm(_attention(q, k, v), w["wo"], fp8)
                x = _rmsnorm(h, n2, eps)
                gate = torch.nn.functional.silu(_mm(x, w["f_wg"], fp8))
                hs[i] = h + _mm(gate * _mm(x, w["f_wi"], fp8), w["f_wo"], fp8)
            del w
        out_w = params["unembed"].float().T
        return [_mm(_rmsnorm(h[st:], params["final_norm"]["scale"], eps), out_w, fp8)
                for h, st in zip(hs, starts)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
