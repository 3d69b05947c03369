"""The prefill attention kernel's share of its roofline in the traced
span (``Record.flash_attention_roofline``), in the chat cells."""

LAYER = "prefill attention kernel (kernels/flash_attention.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "itl_mean_ms"


def read(rec):
    return rec.flash_attention_roofline()
