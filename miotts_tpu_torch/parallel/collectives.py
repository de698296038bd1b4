"""The tensor-parallel group's collectives, written as plain tensor copies.

A group's ranks may share one device (logical ranks, ``MIOTTS_LOGICAL_DEVICES``)
or sit on distinct cards. Either way a collective gathers the ranks'
parts on the group's lead device, combines them there in rank order (so the
result never depends on which rank finished first), and leaves the result
on the lead; a rank that needs it next copies it back with ``to_rank``.
The copies are ``.to(device, non_blocking=True)``, queued on the current
streams of the two devices, which PyTorch orders against each other; where
the devices are one, a copy is no copy at all. No ``torch.distributed``, no
NCCL: one process drives every rank.
"""

from __future__ import annotations

import torch


def to_rank(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on a rank's device (itself where it is there already)."""
    return t.to(device, non_blocking=True)


def tp_sum(parts: list[torch.Tensor], lead: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The sum of the ranks' partial results (the all-reduce after a
    row-parallel matmul), on ``lead``, in rank order: floating parts
    accumulated in f32 and rounded once to ``dtype``, integer parts (the
    int32 dots of W8A8) summed exactly in their own dtype."""
    acc_dtype = torch.float32 if dtype.is_floating_point else dtype
    acc = to_rank(parts[0], lead).to(acc_dtype)
    for p in parts[1:]:
        acc = acc + to_rank(p, lead).to(acc_dtype)
    return acc.to(dtype)


def tp_max(parts: list[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The elementwise max of the ranks' parts, on ``lead`` (exact in any
    order)."""
    acc = to_rank(parts[0], lead)
    for p in parts[1:]:
        acc = torch.maximum(acc, to_rank(p, lead))
    return acc


def gather_vocab(parts: list[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The ranks' vocab shards of the logits [..., V/tp] joined in rank
    order on ``lead``: [..., V]."""
    return torch.cat([to_rank(p, lead) for p in parts], dim=-1)
