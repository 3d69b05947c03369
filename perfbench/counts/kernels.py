"""Operations and bytes of one call of each kernel on the served path, as
these inputs need them: every input byte read once, every output byte
written once (PERF.md's kernel-table rule).  bf16 activations and pages
(2 bytes), f32 state (4)."""

BF16, F32 = 2, 4


def paged_decode(m: dict, contexts: list[int]) -> tuple[float, float]:
    """One layer's decode attention over the pool for the live rows, row
    i seeing ``contexts[i]`` positions (padding rows need nothing)."""
    h, hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    keys = sum(contexts)
    rows = len(contexts)
    nbytes = (2 * keys * hkv * hd + 2 * rows * h * hd) * BF16
    return 4.0 * keys * h * hd, float(nbytes)


def flash_chunk(m: dict, n: int, pos0: int) -> tuple[float, float]:
    """One layer's prefill attention of a chunk of ``n`` queries at
    ``pos0`` over the ``pos0 + n`` keys of its context, causal."""
    h, hkv, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    sk = pos0 + n
    keys = n * pos0 + n * (n + 1) // 2
    nbytes = (2 * n * h * hd + 2 * sk * hkv * hd) * BF16
    return 4.0 * keys * h * hd, float(nbytes)


def ssd_chunk(m: dict, n: int) -> tuple[float, float]:
    """One layer's SSD scan of a prompt chunk of ``n`` tokens continuing
    from a carried state: the causal half of each ``chunk_size`` block's
    C B^T, per head the decayed scores times x, the carried state's term
    and the state update; x, dt, A, B, C and the state read once, y and
    the state written once."""
    d, sn, p = m["d_model"], m["d_state"], m["headdim"]
    heads = m["expand"] * d // p
    block = m["chunk_size"]
    state = heads * p * sn * F32
    nbytes = (2 * n * heads * p * BF16 + n * heads * F32 + heads * F32
              + 2 * n * sn * BF16 + 2 * state)
    pairs = sum(q * (q + 1) // 2 for q in (min(block, n - t) for t in range(0, n, block)))
    flops = 2.0 * pairs * sn + heads * (2.0 * pairs * p + 4.0 * n * p * sn)
    return flops, float(nbytes)
