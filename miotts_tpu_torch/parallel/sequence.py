"""Sequence parallelism by hand: one codec decode's time axis split over an
("sp",) mesh (``mesh.make_sp_mesh``).

The JAX package pins every time-major activation of a decode to the mesh's
"sp" axis and lets GSPMD derive the rest: the conv halos, the reductions
of the masked GroupNorm, the gathers of the bilinear resize
(miotts_tpu/models/miocodec.py:479-489). The port has no partitioner, so
this module holds what GSPMD derives, written out:

- ``Sharded``: one tensor a rank, [B, rows, ...] on the rank's device, with
  the global row of each part's first row. A time axis of T rows splits as
  GSPMD splits it (``split_rows``): rank r holds [r c, (r + 1) c), c =
  ceil(T / sp); the last ranks may hold fewer, or none.
- Exchanges, each a copy through ``collectives.to_rank`` (ranks on one
  device copy nothing): ``fetch`` (any global row range for each rank, from
  whichever ranks hold it), ``halo`` (a shard with its neighbours' rows),
  ``gather_rows`` (rows by global index), ``split`` / ``join`` (to and from
  the lead device).
- Reductions: ``sp_sum`` / ``sp_max`` (f32 partials combined on the lead in
  rank order, as ``collectives.tp_sum`` does, the result copied back to
  every rank).
- ``local_lengths``: a rank's view of per-example lengths.
- The sharded ops a decode is built from, each the mesh-less op's math on
  a rank's rows: ``on_halo`` (any op of bounded reach on a halo-extended
  shard, cropped back), ``conv_transpose`` (the output re-split at the new
  resolution), ``interpolate`` (the bilinear resize by global index),
  ``group_norm`` (two passes, two ``sp_sum``), ``overlap_add`` (the iSTFT
  head's seams) and ``peak_normalize``.

Rows past a global edge: ``fetch`` and ``halo`` fill them with zeros, or,
with ``edge="trim"``, leave them out, so that a rank's row 0 is the
sequence's row 0 on rank 0. An op that reads its input's edge (a replicate
pad, the first row of the snake, attention's keys) needs the trimmed form;
a zero-padded convolution gives the same rows either way.

One process drives every rank: no ``torch.distributed``, no NCCL. Each
rank's work runs inside ``graphs.on_rank(rank id)``, so a kernel launched
for a rank counts for it in ``graphs.rank_launches``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.convs import interp_taps
from ..ops.cuda import graphs
from ..ops.istft import dft_frames, overlap_add as _overlap_add
from ..ops.masking import mask_time
from ..ops.norms import group_count, group_normalize, group_view
from .collectives import to_rank, tp_max, tp_sum
from .mesh import SpMesh


def split_rows(total: int, sp: int) -> list[tuple[int, int]]:
    """GSPMD's split of a ``total``-row axis over ``sp`` ranks: rank r holds
    [r c, (r + 1) c) clipped to ``total``, c = ceil(total / sp)."""
    c = -(-total // sp)
    return [(min(r * c, total), min((r + 1) * c, total)) for r in range(sp)]


@dataclasses.dataclass
class Sharded:
    """A time axis of ``total`` rows over ``mesh``: ``parts[r]`` [B, rows,
    ...] on rank r's device holds global rows [starts[r], starts[r] + rows)."""
    parts: list[torch.Tensor]
    starts: list[int]
    total: int
    mesh: SpMesh

    @property
    def ranges(self) -> list[tuple[int, int]]:
        return [(s, s + p.shape[1]) for s, p in zip(self.starts, self.parts)]


def rank_device(mesh: SpMesh, r: int) -> torch.device:
    return mesh.devices[r].device


def per_rank(mesh: SpMesh, fn: Callable[[int], object]) -> list:
    """[fn(r) for each rank r], each inside ``graphs.on_rank`` of its rank."""
    out = []
    for r, d in enumerate(mesh.devices):
        with graphs.on_rank(d.id):
            out.append(fn(r))
    return out


def replicate(t: torch.Tensor | None, mesh: SpMesh) -> list:
    """``t`` on every rank's device (None stays None)."""
    return [None if t is None else to_rank(t, rank_device(mesh, r))
            for r in range(mesh.devices.size)]


def local_lengths(lengths: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """Per-example lengths as a part of ``rows`` rows from global row
    ``start`` sees them: clamp(lengths - start, 0, rows), int32."""
    return torch.clamp(lengths - start, 0, rows).to(torch.int32)


def split(x: torch.Tensor, mesh: SpMesh) -> Sharded:
    """x [B, T, ...] -> its GSPMD split, each rank's rows on its device."""
    rows = split_rows(x.shape[1], mesh.devices.size)
    parts = [to_rank(x[:, a:b], rank_device(mesh, r)).contiguous()
             for r, (a, b) in enumerate(rows)]
    return Sharded(parts, [a for a, _ in rows], x.shape[1], mesh)


def join(s: Sharded, device: torch.device | None = None) -> torch.Tensor:
    """The whole axis on ``device`` (the lead's by default), from a split
    whose parts cover it in order."""
    if s.ranges != split_rows(s.total, s.mesh.devices.size):
        raise ValueError(f"join needs the axis's split, got rows {s.ranges} of {s.total}")
    device = s.mesh.lead if device is None else device
    return torch.cat([to_rank(p, device) for p in s.parts], dim=1)


def _zeros(like: torch.Tensor, rows: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((like.shape[0], rows) + tuple(like.shape[2:]), dtype=like.dtype,
                       device=device)


def _filled(outs: list, mesh: SpMesh) -> list[torch.Tensor]:
    """The ranks' results, a rank that ran nothing (None) given a part of no
    rows like the others'."""
    like = next(o for o in outs if o is not None)
    return [_zeros(like, 0, rank_device(mesh, r)) if o is None else o for r, o in enumerate(outs)]


def fetch(s: Sharded, ranges: list[tuple[int, int]]) -> Sharded:
    """Rank r's global rows [lo_r, hi_r) of ``s`` (whose parts must not
    overlap), each copied from the rank that holds it; rows past a global
    edge are zeros. Returns a fresh, contiguous part a rank."""
    parts = []
    for r, (lo, hi) in enumerate(ranges):
        dev = rank_device(s.mesh, r)
        pieces = []
        if lo < 0:
            pieces.append(_zeros(s.parts[0], min(hi, 0) - lo, dev))
        for (a, b), p in zip(s.ranges, s.parts):
            u, v = max(lo, a), min(hi, b)
            if u < v:
                pieces.append(to_rank(p[:, u - a:v - a], dev))
        if hi > s.total:
            pieces.append(_zeros(s.parts[0], hi - max(lo, s.total), dev))
        if sum(q.shape[1] for q in pieces) != max(0, hi - lo):
            raise ValueError(f"rows [{lo}, {hi}) are not all held by {s.ranges}")
        parts.append(torch.cat(pieces, dim=1) if pieces else _zeros(s.parts[0], 0, dev))
    return Sharded(parts, [lo for lo, _ in ranges], s.total, s.mesh)


def halo_ranges(ranges: list[tuple[int, int]], total: int, left: int, right: int,
                edge: str = "zeros") -> list[tuple[int, int]]:
    """Each range grown by ``left`` / ``right`` rows; with ``edge="trim"``
    clipped to [0, total)."""
    if edge not in ("zeros", "trim"):
        raise ValueError(f"edge must be 'zeros' or 'trim', got {edge!r}")
    out = [(a - left, b + right) for a, b in ranges]
    if edge == "trim":
        out = [(max(0, a), min(total, b)) for a, b in out]
    return out


def halo(s: Sharded, left: int, right: int, edge: str = "zeros") -> Sharded:
    """Each rank's rows with ``left`` rows before and ``right`` after them,
    copied from its neighbours (as many ranks away as they lie)."""
    return fetch(s, halo_ranges(s.ranges, s.total, left, right, edge))


def crop(ext: Sharded, ranges: list[tuple[int, int]]) -> Sharded:
    """Rank r's global rows ``ranges[r]`` of its own (halo-extended) part."""
    parts = [p[:, a - st:b - st] for p, st, (a, b) in zip(ext.parts, ext.starts, ranges)]
    return Sharded(parts, [a for a, _ in ranges], ext.total, ext.mesh)


def gather_rows(s: Sharded, index: list[torch.Tensor]) -> list[torch.Tensor]:
    """Rows by global index: ``index[r]`` [B, n] (in [0, total)) on rank r's
    device -> [B, n, ...] on that device, read from every rank's part (each
    copied to the rank, joined in order)."""
    out = []
    for r, idx in enumerate(index):
        whole = torch.cat([to_rank(p, idx.device) for p in s.parts], dim=1)
        B, n = idx.shape
        trail = tuple(whole.shape[2:])
        full = idx.reshape((B, n) + (1,) * len(trail)).expand((B, n) + trail)
        out.append(torch.gather(whole, 1, full))
    return out


def sp_sum(parts: list[torch.Tensor], mesh: SpMesh) -> list[torch.Tensor]:
    """The sum of the ranks' f32 partials, taken on the lead in rank order,
    on every rank."""
    return replicate(tp_sum(parts, mesh.lead, torch.float32), mesh)


def sp_max(parts: list[torch.Tensor], mesh: SpMesh) -> list[torch.Tensor]:
    """The elementwise max of the ranks' parts, on every rank."""
    return replicate(tp_max(parts, mesh.lead), mesh)


# ---------------------------------------------------------------------------
# sharded ops: each the mesh-less op's math on a rank's rows
# ---------------------------------------------------------------------------

def on_halo(s: Sharded, left: int, right: int, fn: Callable, edge: str = "trim") -> Sharded:
    """fn(r, part, start) run on each rank's rows grown by a halo of
    ``left`` / ``right`` rows (``fn`` keeps the time axis), its result cropped
    back to the rank's own rows. Right for an op (or a chain of them) that
    reads at most ``left`` rows back and ``right`` ahead; ranks with no rows
    run nothing."""
    ranges = s.ranges
    ext = halo(s, left, right, edge)
    outs = per_rank(s.mesh, lambda r: (None if ranges[r][0] == ranges[r][1]
                                      else fn(r, ext.parts[r], ext.starts[r])))
    starts = [a if o is None else st for o, st, (a, _) in zip(outs, ext.starts, ranges)]
    return crop(Sharded(_filled(outs, s.mesh), starts, s.total, s.mesh), ranges)


def conv_transpose(s: Sharded, fn: Callable, k: int, stride: int, crop_rows: int = 0) -> Sharded:
    """A padding-0 transposed convolution of ``k`` taps and ``stride``
    (``fn(r, x)`` runs it on a rank's input rows), cropped by ``crop_rows``
    a side, its output re-split at the new resolution: each rank's output
    rows read input rows t with stride t + kk - crop_rows in them, kk < k."""
    T_out = (s.total - 1) * stride + k - 2 * crop_rows
    out_rows = split_rows(T_out, s.mesh.devices.size)
    need = []
    for a, b in out_rows:
        t0 = max(0, -(-(a + crop_rows - k + 1) // stride))
        t1 = min(s.total, (b + crop_rows - 1) // stride + 1)
        need.append((t0, t1) if a < b else (0, 0))
    x = fetch(s, need)

    def run(r):
        (a, b), (t0, _) = out_rows[r], need[r]
        if a == b:
            return None
        y = fn(r, x.parts[r])
        return y[:, a + crop_rows - stride * t0:b + crop_rows - stride * t0]
    return Sharded(_filled(per_rank(s.mesh, run), s.mesh), [a for a, _ in out_rows], T_out,
                   s.mesh)


def interpolate(s: Sharded, src_lengths: list, dst_lengths: list, dst_total: int,
                scale_override: tuple[int, int] | None = None) -> Sharded:
    """``ops/convs.py linear_interpolate`` of a sharded source to
    ``dst_total`` rows, split: each rank's output rows take their taps from
    their global row numbers (``interp_taps``, GGML's clamp included) and
    read the source rows by global index (``gather_rows``). The length lists
    hold each rank's copy of the per-example lengths."""
    mesh = s.mesh
    out_rows = split_rows(dst_total, mesh.devices.size)

    def taps(r):
        a, b = out_rows[r]
        dst_idx = torch.arange(a, b, dtype=torch.float32,
                               device=rank_device(mesh, r))[None, :]
        return interp_taps(dst_idx, src_lengths[r], dst_lengths[r], scale_override)
    t = per_rank(mesh, taps)
    g0 = gather_rows(s, [x0 for x0, _, _ in t])
    g1 = gather_rows(s, [x1 for _, x1, _ in t])
    parts = per_rank(mesh, lambda r: g0[r] + (g1[r] - g0[r]) * t[r][2][:, :, None].to(g0[r].dtype))
    return Sharded(parts, [a for a, _ in out_rows], dst_total, mesh)


def group_norm(s: Sharded, lengths: list, num_groups: int, eps: float) -> Sharded:
    """``ops/norms.py masked_group_norm`` over the whole axis: the masked
    mean, then the masked centered variance, each a sum of per-rank f32
    partials (``sp_sum``); ``lengths`` holds each rank's copy of the global
    lengths."""
    mesh = s.mesh
    views = per_rank(mesh, lambda r: group_view(
        s.parts[r], local_lengths(lengths[r], s.starts[r], s.parts[r].shape[1]), num_groups))
    counts = [group_count(lengths[r], xf.shape[-1]) for r, (xf, _) in enumerate(views)]
    sums = sp_sum([(xf * m).sum(dim=(1, 3), keepdim=True) for xf, m in views], mesh)
    mean = [t / c for t, c in zip(sums, counts)]
    sq = sp_sum([(torch.square(xf - mu) * m).sum(dim=(1, 3), keepdim=True)
                 for (xf, m), mu in zip(views, mean)], mesh)
    parts = per_rank(mesh, lambda r: group_normalize(
        s.parts[r], views[r][0], views[r][1], mean[r], sq[r] / counts[r], eps))
    return Sharded(parts, list(s.starts), s.total, mesh)


def overlap_add(spec: Sharded, frame_lengths: list, n_fft: int, hop: int, tables: list) -> Sharded:
    """``ops/istft.py spec_to_audio`` of a sharded spectrogram [B, L, n_fft+2]
    into audio split over its (L - 1) hop + n_fft - 2 n_pad samples. A rank's
    samples [a, b) lie in hop-chunks c0..c1 (after the n_pad crop), which
    the frames c0 - r + 1 .. c1 reach (r = ceil(n_fft / hop)): it fetches
    those frames, trimmed at the global edges so that the Hann^2 envelope
    counts only frames that exist, runs the DFT and the overlap-add on them
    and keeps its samples. ``tables`` holds each rank's (cos, sin, hann)."""
    mesh = spec.mesh
    L = spec.total
    r_ov = -(-n_fft // hop)
    n_pad = (n_fft - hop) // 2
    S = (L - 1) * hop + n_fft - 2 * n_pad
    out_rows = split_rows(S, mesh.devices.size)
    need = []
    for a, b in out_rows:
        c0, c1 = (a + n_pad) // hop, (b - 1 + n_pad) // hop
        need.append((max(0, c0 - r_ov + 1), min(L, c1 + 1)) if a < b else (0, 0))
    frames = fetch(spec, need)

    def run(r):
        (a, b), (f0, f1) = out_rows[r], need[r]
        if a == b:
            return None
        ft = dft_frames(frames.parts[r], n_fft, tables[r])
        audio = _overlap_add(ft, local_lengths(frame_lengths[r], f0, f1 - f0), n_fft, hop,
                             tables[r][2])
        return audio[:, a + n_pad - f0 * hop:b + n_pad - f0 * hop]
    return Sharded(_filled(per_rank(mesh, run), mesh), [a for a, _ in out_rows], S, mesh)


def map_rows(s: Sharded, fn: Callable) -> Sharded:
    """fn(r, part, start) on each rank's own rows (an op that reads no other
    row: per frame, per sample)."""
    return Sharded(per_rank(s.mesh, lambda r: fn(r, s.parts[r], s.starts[r])), list(s.starts),
                   s.total, s.mesh)


def mask_rows(s: Sharded, lengths: list) -> Sharded:
    """``mask_time`` of each rank's rows against the global lengths."""
    return map_rows(s, lambda r, p, start: mask_time(
        p, local_lengths(lengths[r], start, p.shape[1])))


def peak_normalize(audio: Sharded) -> Sharded:
    """mio_tts_synthesize's peak rule over the whole axis: the largest finite
    |sample| of each example (``sp_max`` of the ranks' own), and where it
    passes 0.98 every rank scales its rows by 0.95 / peak."""
    mesh = audio.mesh

    def own_peak(r):
        a = audio.parts[r]
        if a.shape[1] == 0:
            return torch.zeros((a.shape[0],), dtype=a.dtype, device=a.device)
        finite = torch.where(torch.isfinite(a), a, torch.zeros((), device=a.device))
        return finite.abs().amax(dim=1)
    peaks = sp_max(per_rank(mesh, own_peak), mesh)

    def scale(r):
        a, peak = audio.parts[r], peaks[r]
        gain = torch.where(peak > 0.98, 0.95 / torch.clamp(peak, min=1e-9),
                           torch.ones((), device=a.device))
        return a * gain[:, None]
    return Sharded(per_rank(mesh, scale), list(audio.starts), audio.total, mesh)
