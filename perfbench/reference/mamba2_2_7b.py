"""Plain PyTorch reference of Mamba-2 (arXiv:2405.21060; the
``MambaLMHeadModel`` of state-spaces/mamba2-2.7b), in float32 with TF32
off, for the benchmark's check.  It imports nothing of the program.

The architecture, as published: token embedding; per layer a pre-norm
RMSNorm and a Mamba-2 mixer with a residual add; a final RMSNorm and the
tied embedding as the output matrix.  The mixer: ``in_proj`` to ``[z, x,
B, C, dt]`` (one group), a causal depthwise conv of width ``d_conv`` with
bias over ``[x, B, C]`` and a SiLU, ``dt = softplus(dt + dt_bias)``, ``A =
-exp(A_log)``, the SSD scan ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
``y_t = h_t C_t + D x_t``, the gated RMSNorm ``norm(y * silu(z))``
(``norm_before_gate=False``) and ``out_proj``.  The scan is the paper's
minimal chunked form (``ssd_minimal_discrete``, chunks of
``chunk_size``), written here anew.

The weights are the harness's seeded tensors, as the program is handed
them: matrices stored ``(in, out)`` and stacked over the layers under
``blocks/layer0``; an RMSNorm's gain is ``1 + scale``; the conv taps
``conv_w`` are ``(d_conv, channels)``, tap ``i`` multiplying the input
``d_conv - 1 - i`` steps back.  The output matrix has as many rows as the
harness gave the embedding (the program pads the vocabulary), and every
row is scored.  Departures from the published model, taken from the
configuration file as run: ``rms_norm_eps``.

``fp8=True`` is the benchmark's control: every product with a weight
matrix (and the output matrix) takes its operands rounded to float8 e4m3,
products summed in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry [i, j] = sum of x[j+1..i] for j <= i,
    -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=-1)
    x = x.masked_fill(~low, 0.0)
    seg = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=0)
    return seg.masked_fill(~keep, float("-inf"))


def _ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         block: int) -> torch.Tensor:
    """The minimal chunked SSD, one sequence, one group: x (S, H, P) already
    times dt, a (S, H) = dt * A, b/c (S, N); zero initial state.  S is a
    multiple of ``block``."""
    s, h, p = x.shape
    n = b.shape[-1]
    nc = s // block
    x = x.view(nc, block, h, p)
    b = b.view(nc, block, n)
    c = c.view(nc, block, n)
    a = a.view(nc, block, h).permute(2, 0, 1)  # (H, c, l)
    a_cum = torch.cumsum(a, dim=-1)
    # 1. within each chunk (the diagonal blocks)
    decay = torch.exp(_segsum(a))  # (H, c, l, s)
    cb = torch.einsum("cln,csn->cls", c, b)  # (c, l, s)
    y = torch.einsum("hcls,cls,cshp->clhp", decay, cb, x)
    # 2. each chunk's final state from its own inputs
    to_end = torch.exp(a_cum[:, :, -1:] - a_cum)  # (H, c, l)
    states = torch.einsum("cln,hcl,clhp->chpn", b, to_end, x)
    # 3. states passed between chunks
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[:, :, -1], (1, 0))))  # (H, c+1, c+1)
    states = torch.einsum("hzc,chpn->zhpn", chunk_decay, states)[:-1]
    # 4. the carried state's part of each output
    y = y + torch.einsum("cln,chpn,hcl->clhp", c, states, torch.exp(a_cum))
    return y.reshape(s, h, p)


@torch.no_grad()
def logits(model: dict, params: dict, seqs: list, starts: list[int], *,
           device, fp8: bool = False) -> list[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (ints), the float32 logits at
    positions ``starts[i]`` to its end: (len - start, rows of the output
    matrix), on ``device``.  Runs layer by layer over all the sequences."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps = model["rms_norm_eps"]
        d, n, p, width = model["d_model"], model["d_state"], model["headdim"], model["d_conv"]
        di = model["expand"] * d
        heads = di // p
        block = model["chunk_size"]
        blocks = params["blocks"]["layer0"]
        mix = blocks["mixer"]
        toks = [torch.as_tensor(s, dtype=torch.long, device=device) for s in seqs]
        hs = [params["embed"][t].float() for t in toks]
        for li in range(model["n_layer"]):
            w_in, w_out = mix["in_proj"][li].float(), mix["out_proj"][li].float()
            conv_w, conv_b = mix["conv_w"][li].float(), mix["conv_b"][li].float()
            a_neg = -torch.exp(mix["A_log"][li].float())
            for i, h in enumerate(hs):
                s = h.shape[0]
                zxbcdt = _mm(_rmsnorm(h, blocks["mixer_norm"]["scale"][li], eps), w_in, fp8)
                z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di: 2 * di + 2 * n], zxbcdt[:, 2 * di + 2 * n:]
                pad = F.pad(xbc, (0, 0, width - 1, 0))
                conv = sum(pad[j: j + s] * conv_w[j] for j in range(width)) + conv_b
                conv = F.silu(conv)
                x = conv[:, :di].view(s, heads, p)
                b, c = conv[:, di: di + n], conv[:, di + n:]
                dt = F.softplus(dt + mix["dt_bias"][li].float())  # (S, H)
                extra = -(-s // block) * block - s  # zero rows: dt 0 leaves the state
                y = _ssd(F.pad(x * dt[..., None], (0, 0, 0, 0, 0, extra)),
                         F.pad(dt * a_neg, (0, 0, 0, extra)), F.pad(b, (0, 0, 0, extra)),
                         F.pad(c, (0, 0, 0, extra)), block)[:s]
                y = y + mix["D"][li].float()[:, None] * x
                y = _rmsnorm(y.reshape(s, di) * F.silu(z), mix["norm"]["scale"][li], eps)
                hs[i] = h + _mm(y, w_out, fp8)
        out_w = params["embed"].float().T
        return [_mm(_rmsnorm(h[st:], params["final_norm"]["scale"], eps), out_w, fp8)
                for h, st in zip(hs, starts)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
