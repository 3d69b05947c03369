"""Speculative decode of the port: drafters and the greedy verify step."""

from repro_torch.runtime.spec.drafter import Drafter, NGramDrafter
from repro_torch.runtime.spec.verify import greedy_accept, make_verifier, verify_greedy

__all__ = ["Drafter", "NGramDrafter", "greedy_accept", "make_verifier", "verify_greedy"]
