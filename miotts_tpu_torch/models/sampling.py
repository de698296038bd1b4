"""Sampler chain: repeat penalty -> top-k -> top-p -> temperature ->
categorical (miotts_tpu/models/sampling.py:26-157).

Order and semantics mirror the reference's llama.cpp chain:
- penalties(last_n=64): tokens in the last-64 ring get logit/p (if > 0)
  else logit*p
- top_k when k > 0 (exact, ``torch.topk``)
- top_p when 0 < p < 1 (min_keep = 1)
- temperature then a categorical draw from an explicit ``torch.Generator``;
  greedy when temp <= 0

The JAX tile prefilter for top-k is a TPU sort workaround and is not
ported. Token-exact RNG parity with JAX (or llama.cpp) is impossible by
construction: conformance is distributional.
"""

from __future__ import annotations

import dataclasses

import torch

PENALTY_LAST_N = 64


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    temp: float = 0.8
    top_k: int = 50
    top_p: float = 1.0
    repeat_penalty: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class SamplerState:
    """Penalty ring [B, PENALTY_LAST_N] (-1 = empty) and its write cursor."""
    ring: torch.Tensor
    idx: int = 0

    @classmethod
    def init(cls, batch: int, device: torch.device) -> "SamplerState":
        return cls(torch.full((batch, PENALTY_LAST_N), -1, dtype=torch.int64, device=device))

    def update(self, token: torch.Tensor) -> None:
        """Record this step's tokens [B] (in place)."""
        self.ring[:, self.idx % PENALTY_LAST_N] = token
        self.idx += 1


def apply_repeat_penalty(logits: torch.Tensor, state: SamplerState, penalty: float) -> torch.Tensor:
    """logits [B, V] f32."""
    B, V = logits.shape
    presence = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    safe = torch.where(state.ring >= 0, state.ring, torch.full_like(state.ring, V))
    presence.scatter_(1, safe, True)
    presence = presence[:, :V]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def sample_token(logits: torch.Tensor, params: SamplerParams, state: SamplerState,
                 generator: torch.Generator) -> torch.Tensor:
    """One sampler-chain step. logits [B, V] f32 -> token ids [B] int64."""
    B, V = logits.shape
    if params.repeat_penalty != 1.0:
        logits = apply_repeat_penalty(logits, state, params.repeat_penalty)

    top_p_on = 0.0 < params.top_p < 1.0
    if params.top_k > 0:
        vals, idx = torch.topk(logits, min(params.top_k, V), dim=-1)
    elif top_p_on:
        vals, idx = torch.sort(logits, dim=-1, descending=True)
    else:
        vals, idx = logits, None

    if top_p_on:
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < params.top_p  # include the crossing token
        keep[:, 0] = True  # min_keep = 1
        vals = vals.masked_fill(~keep, float("-inf"))

    if params.temp <= 0.0:
        choice = torch.argmax(vals, dim=-1)
    else:
        probs = torch.softmax(vals / params.temp, dim=-1)
        choice = torch.multinomial(probs, 1, generator=generator)[:, 0]
    if idx is None:
        return choice
    return torch.gather(idx, 1, choice[:, None])[:, 0]
