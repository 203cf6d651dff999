"""Per-request accounting of the port (its own copy of ``RequestRecord``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RequestRecord:
    """One completed generation request, timestamped in seconds."""

    rid: int
    arrival_t: float
    first_token_t: float          # when the first output token reached the client
    complete_t: float
    prompt_len: int
    tokens: int                   # tokens actually delivered
    retries: int = 0
    tier: str = ""
    replica: str = ""
    slo_class: str = "interactive"

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def latency_s(self) -> float:
        return self.complete_t - self.arrival_t

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first (0 for 1-token outputs)."""
        if self.tokens <= 1:
            return 0.0
        return (self.complete_t - self.first_token_t) / (self.tokens - 1)
