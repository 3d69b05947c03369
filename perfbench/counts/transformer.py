"""Model flops of a dense decoder-only transformer with grouped-query
attention and a gated FFN, from the configuration's ``model`` block
(published key names).  Two flops a multiply-add."""


def flops(m: dict, *, tokens: int, keys: int, logit_rows: int) -> float:
    """``tokens`` processed, attending to ``keys`` positions in all (each
    token's context, itself included), with ``logit_rows`` rows of the
    vocabulary product."""
    d, hd = m["hidden_size"], m["head_dim"]
    h, hkv, ff = m["num_attention_heads"], m["num_key_value_heads"], m["intermediate_size"]
    layers = m["num_hidden_layers"]
    per_token = 2 * (d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * ff)
    per_key = 4 * h * hd  # q k^T and p v
    return (layers * (per_token * tokens + per_key * keys)
            + 2 * d * m["vocab_size"] * logit_rows)
