"""Speculative decode of the port: drafters and the verify step (greedy,
or rejection sampling at temperature)."""

from repro_torch.runtime.spec.drafter import Drafter, NGramDrafter
from repro_torch.runtime.spec.verify import (greedy_accept, make_verifier, verify_greedy,
                                             verify_sampled)

__all__ = ["Drafter", "NGramDrafter", "greedy_accept", "make_verifier", "verify_greedy",
           "verify_sampled"]
