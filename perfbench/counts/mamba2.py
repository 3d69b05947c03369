"""Model flops of a Mamba-2 stack (single group, gated RMSNorm, no FFN),
from the configuration's ``model`` block (published key names).  The
state-space mixing is counted in its recurrent form, whatever the path:
per token and head the state update x B^T and the read-out C^T h, four
flops per state entry.  Two flops a multiply-add."""


def flops(m: dict, *, tokens: int, keys: int, logit_rows: int) -> float:
    """``tokens`` processed (``keys`` unused: the state is O(1)), with
    ``logit_rows`` rows of the vocabulary product."""
    d, n, p = m["d_model"], m["d_state"], m["headdim"]
    di = m["expand"] * d
    heads = di // p
    conv_dim = di + 2 * n
    per_token = (2 * (d * (2 * di + 2 * n + heads) + di * d)
                 + 2 * m["d_conv"] * conv_dim + 4 * heads * p * n)
    return m["n_layer"] * per_token * tokens + 2 * d * m["vocab_size"] * logit_rows
