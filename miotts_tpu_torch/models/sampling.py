"""Sampler chain: repeat penalty -> top-k -> top-p -> temperature ->
categorical (miotts_tpu/models/sampling.py:26-157).

Order and semantics mirror the reference's llama.cpp chain:
- penalties(last_n=64): tokens in the last-64 ring get logit/p (if > 0)
  else logit*p
- top_k when k > 0 (exact, ``torch.topk``)
- top_p when 0 < p < 1 (min_keep = 1)
- temperature then a categorical draw by Gumbel-max (argmax of logits/temp
  plus Gumbel noise), the rule ``jax.random.categorical`` uses; greedy
  when temp <= 0

Every step is device ops on device state, with no read back to the host,
so a chain of steps can be captured in a CUDA graph and replayed
(``models/decode_graph.py``): the ring's write cursor is a device int32
scalar, as JAX's is, and the ring is written at a device index. The draw's
randomness is counter-based, the counterpart of a JAX PRNG key: a device
``key`` [2] int64 holds (seed, draws so far), and each candidate's uniform
is an integer hash of (seed, draw, element index). A replayed graph and
the eager body therefore draw the same numbers from the same key, and a
seed reproduces its tokens without any generator state outside the graph.

The server's lanes each carry their own request (``sample_token_batched``,
miotts_tpu/models/sampling.py:165-232): every knob is a [B] device tensor,
and the key is per lane, [B, 2] (seed, draws so far), each lane's uniforms
indexed within its own row (``uniform_lanes``). So a lane's draws depend
only on its seed and its steps since it attached, never on its
neighbours; at B = 1 they are ``uniform``'s bit for bit.

The JAX tile prefilter for top-k is a TPU sort workaround and is not
ported. Token-exact RNG parity with JAX (or llama.cpp) is impossible by
construction: conformance is distributional.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import to_device

PENALTY_LAST_N = 64
_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B  # the multiplier of a 32-bit integer hash; x * _MIX < 2^59, no int64 overflow


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    temp: float = 0.8
    top_k: int = 50
    top_p: float = 1.0
    repeat_penalty: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class SamplerState:
    """Penalty ring [B, PENALTY_LAST_N] int64 (-1 = empty) and its write
    cursor, a device int32 scalar."""
    ring: torch.Tensor
    idx: torch.Tensor

    @classmethod
    def init(cls, batch: int, device: torch.device) -> "SamplerState":
        return cls(torch.full((batch, PENALTY_LAST_N), -1, dtype=torch.int64, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))

    def update(self, token: torch.Tensor) -> None:
        """Record this step's tokens [B] at the cursor and advance it, both
        in place on the device (update_sampler_state)."""
        col = torch.remainder(self.idx, PENALTY_LAST_N).long().reshape(1)
        self.ring.index_copy_(1, col, token.to(self.ring.dtype)[:, None])
        self.idx.add_(1)


def sampler_key(seed: int, device: torch.device) -> torch.Tensor:
    """The draw's random state: [2] int64 (seed mod 2^32, draws so far)."""
    return torch.tensor([seed & _M32, 0], dtype=torch.int64, device=device)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective hash of 32-bit values held in int64."""
    x = ((x >> 16) ^ x) * _MIX & _M32
    x = ((x >> 16) ^ x) * _MIX & _M32
    return (x >> 16) ^ x


def _unit(base: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """f32 in (0, 1) from the hash of (base + element index): its top 23
    bits plus a half, so 0 and 1 never occur."""
    return ((_mix32((base + i) & _M32) >> 9).float() + 0.5) * 2.0 ** -23


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """f32 uniforms in (0, 1) for draw ``key[1]`` of seed ``key[0]``: the
    hash of (hash(hash(seed) + draw) + element index)."""
    base = _mix32((_mix32(key[0]) + key[1]) & _M32)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    return _unit(base, i)


def uniform_lanes(key: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] f32 uniforms in (0, 1), row b for draw ``key[b, 1]`` of seed
    ``key[b, 0]``, its elements indexed 0..n-1 within the row: row b is
    ``uniform(key[b], (1, n))`` bit for bit."""
    base = _mix32((_mix32(key[:, 0]) + key[:, 1]) & _M32)[:, None]
    return _unit(base, torch.arange(n, dtype=torch.int64, device=key.device)[None, :])


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
                 key: torch.Tensor) -> torch.Tensor:
    """One sampler-chain step. logits [B, V] f32 -> token ids [B] int64. A
    draw reads ``key`` (``sampler_key``) and leaves it as it is; the caller
    advances its draw count."""
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
        # Gumbel-max: argmax(v / T + G), G = -log(-log(U)), U ~ (0, 1), is a
        # draw from softmax(v / T)
        u = uniform(key, tuple(vals.shape))
        choice = torch.argmax(vals / params.temp - torch.log(-torch.log(u)), dim=-1)
    if idx is None:
        return choice
    return torch.gather(idx, 1, choice[:, None])[:, 0]


# ---------------------------------------------------------------------------
# per-lane (batched) sampler: a server's lanes carry different requests
# ---------------------------------------------------------------------------

MAX_TOP_K = 256  # the static candidate pool; a lane's top_k masks within it


@dataclasses.dataclass
class BatchSamplerParams:
    """Per-lane sampler settings, four [B] device tensors (a chunk graph
    reads them as static buffers, so one capture serves any mix)."""
    temp: torch.Tensor  # f32
    top_k: torch.Tensor  # int32; 0 = off
    top_p: torch.Tensor  # f32
    repeat_penalty: torch.Tensor  # f32

    @classmethod
    def make(cls, temps, top_ks, top_ps, penalties, device: torch.device
             ) -> "BatchSamplerParams":
        def t(v, dtype):
            return to_device(np.asarray(v, dtype).reshape(-1), device)
        return cls(t(temps, np.float32), t(top_ks, np.int32), t(top_ps, np.float32),
                   t(penalties, np.float32))

    def copy_(self, src: "BatchSamplerParams") -> None:
        """Copy ``src``'s settings into these tensors in place."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(src, f.name))

    def set_lane(self, i: int, p: "SamplerParams") -> None:
        """Write one lane's settings into these tensors in place."""
        self.temp[i] = p.temp
        self.top_k[i] = min(p.top_k, MAX_TOP_K) if p.top_k > 0 else 0
        self.top_p[i] = p.top_p
        self.repeat_penalty[i] = p.repeat_penalty


def sampler_keys(seeds, device: torch.device) -> torch.Tensor:
    """Per-lane random state [k, 2] int64: (seed mod 2^32, 0 draws)."""
    seeds = np.asarray(seeds, np.int64).reshape(-1) & _M32
    return to_device(np.stack([seeds, np.zeros_like(seeds)], axis=1), device)


def sample_token_batched(logits: torch.Tensor, params: BatchSamplerParams,
                         state: SamplerState, key: torch.Tensor) -> torch.Tensor:
    """The chain of ``sample_token`` with every knob a per-lane tensor and
    ``key`` per lane ([B, 2]); logits [B, V] f32 -> tokens [B] int64.

    The JAX package's documented deviation holds: a lane with top_k <= 0
    or top_k > MAX_TOP_K samples from the MAX_TOP_K highest logits, not the
    whole vocabulary. For top_k <= MAX_TOP_K a lane picks what
    ``sample_token`` picks from the same logits, ring and key."""
    B, V = logits.shape
    pen = params.repeat_penalty[:, None]
    presence = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    presence.scatter_(1, torch.where(state.ring >= 0, state.ring, torch.full_like(state.ring, V)),
                      True)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    logits = torch.where(presence[:, :V] & (pen != 1.0), penalized, logits)

    K = min(MAX_TOP_K, V)
    vals, idx = torch.topk(logits, K, dim=-1)  # [B, K] descending
    rank = torch.arange(K, dtype=torch.int32, device=logits.device)[None, :]
    k_eff = torch.where(params.top_k > 0, params.top_k.clamp(max=K), K)
    vals = vals.masked_fill(rank >= k_eff[:, None], float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p_on = (params.top_p > 0.0) & (params.top_p < 1.0)
    keep = ((cum - probs) < params.top_p[:, None]) | ~p_on[:, None]
    keep[:, 0] = True
    vals = vals.masked_fill(~keep, float("-inf"))

    greedy = torch.argmax(vals, dim=-1)
    temp = params.temp.clamp(min=1e-6)[:, None]
    sampled = torch.argmax(vals / temp - torch.log(-torch.log(uniform_lanes(key, K))), dim=-1)
    choice = torch.where(params.temp <= 0.0, greedy, sampled)
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def advance(tok: torch.Tensor, key: torch.Tensor, state: SamplerState, eog_ids: torch.Tensor,
            rem: torch.Tensor | None, done: torch.Tensor, count: torch.Tensor, out: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A chunk step's bookkeeping after its draw of ``tok`` [B], IN PLACE:
    the draw count in ``key`` (the CLI's one key [2], or a key per lane [B,
    2]), the ring at the shared cursor and the cursor, ``out`` [B] (this
    step's output token: 0 for a lane already done), ``count`` [B] (+1
    where not done) and ``done`` [B] (an EOG token, or ``count`` reaching
    the lane's budget ``rem`` [B]; None: no budget). Returns (tok, adv [B]
    int32: 1 where the lane is not done, its pos advance after the decode
    step)."""
    key[..., 1].add_(1)
    state.update(tok)
    out.copy_(torch.where(done, torch.zeros_like(tok), tok))
    count.add_((~done).to(count.dtype))
    stop = (tok[:, None] == eog_ids[None, :]).any(dim=-1)
    done |= stop if rem is None else stop | (count >= rem)
    return tok, (~done).to(torch.int32)


def sample_step_plain(logits: torch.Tensor, params: BatchSamplerParams, state: SamplerState,
                      key: torch.Tensor, eog_ids: torch.Tensor, rem: torch.Tensor,
                      done: torch.Tensor, count: torch.Tensor, out: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the served chunk body's sampler and bookkeeping
    (miotts_tpu/models/llm.py ``_chunk_loop_batched``): the lanes' tokens
    from ``logits`` [B, V] (``sample_token_batched``), then ``advance``.
    The plain version of K10 (``ops/cuda/llm_fused.py sample_step``)."""
    return advance(sample_token_batched(logits, params, state, key), key, state, eog_ids, rem,
                   done, count, out)


def sample_chain_step(logits: torch.Tensor, params: SamplerParams, state: SamplerState,
                      key: torch.Tensor, eog_ids: torch.Tensor, rem: torch.Tensor | None,
                      done: torch.Tensor, count: torch.Tensor, out: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the CLI's chunk body: ``sample_token`` with one
    ``SamplerParams`` and one key [2] (the whole vocabulary where top_k >
    MAX_TOP_K, or top_k = 0 with top-p), then ``advance``."""
    return advance(sample_token(logits, params, state, key), key, state, eog_ids, rem, done,
                   count, out)
