"""The port's plain attention versions against the JAX kernels on the CPU.

Banded attention: the port's CPU path (dense and blocked, and the [B, T, H,
D] plain version that kernel K1 is checked against on the card, through
K1's wrapper) against ``banded_attention_pallas(..., interpret=True)`` and
``banded_attention_dense``, atol 1e-5 (f32 sums in another order). K1's
launch plan at the codec's request shapes, its wrapper's refusals, and its
tile/warp/slot index arithmetic, emulated here, against the plain version.

Decode attention: the port's plain version (what kernel K2 is checked
against on the card) against ``decode_attention_pallas(..., interpret=True)``
on the cases of tests/test_llm.py's kernel test: atol 1e-5 for f32 caches,
2e-2 for bf16 (one bf16 ulp at |x| in [2, 4) is 1.6e-2). K2's split of the
cache over a cluster of 8 blocks and its combine, emulated here, against
both at the same tolerances, and K2's launch geometry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.ops.attention import banded_attention_dense as jax_dense
from miotts_tpu.ops.pallas.banded_attention import banded_attention_pallas
from miotts_tpu.ops.pallas.decode_attention import decode_attention_pallas
from miotts_tpu_torch.ops.attention import (
    banded_attention, banded_attention_blocked, banded_attention_dense)
from miotts_tpu_torch.ops.cuda import banded_attention as k1
from miotts_tpu_torch.ops.cuda import decode_attention as k2
from miotts_tpu_torch.ops.cuda.decode_attention import decode_attention, decode_attention_plain

torch.set_num_threads(1)


def _qkv(B, T, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


# T not a multiple of the 64-row tile, T < window (JAX takes the dense
# path there), and lengths far below T so most rows are padding
@pytest.mark.parametrize("T,window,lengths", [
    (200, 65, [200, 117]),
    (40, 65, [40, 9]),
    (300, 65, [300, 30]),
    (97, 9, [97, 1]),
])
def test_banded_matches_pallas_interpret(T, window, lengths):
    B, H, D = len(lengths), 2, 16
    q, k, v = _qkv(B, T, H, D, seed=T)
    lens = np.asarray(lengths, np.int32)

    def fold(x):
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, T, D))

    ref = np.asarray(banded_attention_pallas(
        jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(v)),
        jnp.asarray(np.repeat(lens, H)), window, interpret=True))
    ref4 = ref.reshape(B, H, T, D).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(lens)
    # K1's wrapper on a CPU tensor: its plain version, in the trunk's layout
    got = k1.banded_attention(tq, tk, tv, tl, window)
    np.testing.assert_allclose(got.numpy(), ref4, atol=1e-5, rtol=0)
    for fn in (banded_attention, banded_attention_dense, banded_attention_blocked):
        np.testing.assert_allclose(fn(tq, tk, tv, tl, window).numpy(), ref4, atol=1e-5, rtol=0)
    dense = np.asarray(jax_dense(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lens), window))
    np.testing.assert_allclose(banded_attention(tq, tk, tv, tl, window).numpy(), dense,
                               atol=1e-5, rtol=0)
    assert np.all(np.isfinite(got.numpy()))


def test_kernel_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device reaches
    the kernel path, which refuses what it cannot launch."""
    q = torch.zeros((2, 70, 3, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.banded_attention(q, q, q, torch.zeros(2, dtype=torch.int32, device="meta"), 65)
    qh = torch.zeros((1, 2, 6, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.zeros((1, 2, 64), dtype=torch.bfloat16, device="meta")
    cache = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        decode_attention(qh, kv, kv, cache, cache, 0.125, torch.zeros(1, dtype=torch.int32))


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


# each case breaks one of K1's input rules; the wrapper refuses it before
# it reaches the device check (a meta tensor is not a CUDA one)
@pytest.mark.parametrize("case,match", [
    ("dtype", "contiguous f32"), ("lengths shape", "lengths must be"),
    ("lengths dtype", "lengths must be"), ("qkv shapes", "!= q"), ("rank", "must be"),
    ("not contiguous", "not contiguous"), ("window", "key slots"),
])
def test_k1_wrapper_refuses(case, match):
    B, T, H, D = 2, 70, 3, 64
    q = k = v = _meta(B, T, H, D)
    lengths, window = _meta(B, dtype=torch.int32), 65
    if case == "dtype":
        q = _meta(B, T, H, D, dtype=torch.bfloat16)
    elif case == "lengths shape":
        lengths = _meta(B, 1, dtype=torch.int32)
    elif case == "lengths dtype":
        lengths = _meta(B, dtype=torch.int64)
    elif case == "qkv shapes":
        k = _meta(B, T + 1, H, D)
    elif case == "rank":
        q = k = v = _meta(B * H, T, D)
    elif case == "not contiguous":
        q = _meta(B, T, 3, H, D)[:, :, 0]
    elif case == "window":
        window = 301
    with pytest.raises(ValueError, match=match):
        k1.banded_attention(q, k, v, lengths, window)


# the codec's request shapes (D = 64, window 65): a 400-code request's
# prenet and decoder, a 40-code request's; then a ragged batch, the
# run-time width instance and a narrow window
@pytest.mark.parametrize("B,T,H,D,window", [
    (1, 512, 12, 64, 65), (1, 1024, 8, 64, 65), (1, 64, 12, 64, 65), (1, 128, 8, 64, 65),
    (4, 1024, 8, 64, 65), (2, 300, 3, 96, 65), (1, 97, 2, 30, 9),
])
def test_k1_launch_shape(B, T, H, D, window):
    """K1's grid covers every query row of every (example, head) exactly
    once; it gives every SM of the H100 a block where the work allows and
    else runs one block per (head, 16 rows); a lane's key slots cover the
    span of its warp's rows; the shared memory fits."""
    p = k1.launch_shape(B, T, H, D, window)
    half = window // 2
    assert p.tile == p.warps * k1.ROWS and p.warps in k1.TILE_WARPS
    assert p.grid[1:] == (H, B) and (p.grid[0] - 1) * p.tile < T <= p.grid[0] * p.tile
    blocks = int(np.prod(p.grid))
    assert blocks >= 132 or p.tile == 16
    if (T, H) in ((512, 12), (1024, 8)):
        assert blocks >= 132
    if (T, H) in ((64, 12), (128, 8)) and B == 1:
        assert p.tile == 16 and blocks == H * T // 16
    assert (p.slots - 1) * 32 < k1.ROWS + 2 * half <= p.slots * 32 <= k1.MAX_SLOTS * 32
    assert p.compiled == (D == 64 and window == 65)
    assert p.smem <= k1.MAX_SMEM


def _k1_emulation(q, k, v, lengths, window):
    """Kernel K1's index arithmetic in float32 torch: for each block (query
    tile) and warp (4 rows), the staged rows (rows outside [0, T)
    left unset: NaN here; width zero-padded to a multiple of 4), the key
    slots (lane + 32 s, clamped to the staged rows), the mask, the
    normalized probabilities of the first span = 4 + 2 half slots, and
    their product with the staged V rows of the span that lie in [0, T).
    Rows a warp does not own stay NaN."""
    B, T, H, D = q.shape
    p = k1.launch_shape(B, T, H, D, window)
    half, R = window // 2, k1.ROWS
    span, rows_kv, Dr = R + 2 * half, p.tile + 2 * half, -(-D // 4) * 4
    out = torch.full_like(q, float("nan"))

    def stage(x, b, h, t0, n):
        rows = torch.arange(t0, t0 + n)
        ok = (rows >= 0) & (rows < T)
        buf = torch.full((n, Dr), float("nan"))
        buf[ok] = 0.0
        buf[ok, :D] = x[b, rows[ok], h]
        return buf

    for b in range(B):
        L = min(max(int(lengths[b]), 0), T)
        for h in range(H):
            for blk in range(p.grid[0]):
                q0 = blk * p.tile
                k0 = q0 - half
                qs = stage(q, b, h, q0, p.tile)
                ks, vs = stage(k, b, h, k0, rows_kv), stage(v, b, h, k0, rows_kv)
                for w in range(p.warps):
                    r0 = w * R
                    if q0 + r0 >= T:
                        continue
                    qi = q0 + r0 + torch.arange(R)
                    j = torch.arange(p.slots * 32)
                    s = qs[r0:r0 + R] @ ks[torch.clamp(r0 + j, max=rows_kv - 1)].T
                    kp = k0 + r0 + j
                    allow = ((kp[None] == qi[:, None])
                             | (((kp[None] - qi[:, None]).abs() <= half)
                                & (kp >= 0)[None] & (kp < L)[None]))
                    s = torch.where(allow, s / np.sqrt(D), torch.tensor(float("-inf")))
                    e = torch.exp(s - s.amax(-1, keepdim=True))
                    pr = (e * (1.0 / e.sum(-1, keepdim=True)))[:, :span]
                    jlo, jhi = max(0, -(k0 + r0)), min(span, T - (k0 + r0))
                    o = pr[:, jlo:jhi] @ vs[r0 + jlo:r0 + jhi]
                    for r in range(R):
                        if qi[r] < T:
                            out[b, qi[r], h] = o[r, :D]
    return out


@pytest.mark.parametrize("B,T,H,D,window,lengths", [
    (2, 70, 2, 64, 65, [70, 23]),   # two 16-row tiles and a ragged tail
    (1, 64, 3, 64, 65, [40]),       # a 40-code prenet's T
    (3, 50, 1, 30, 9, [50, 0, 7]),  # run-time width (not a multiple of 4), narrow window
    (1, 1060, 4, 16, 65, [1000]),   # 32-row tiles (140 blocks)
])
def test_k1_tile_emulation_matches_plain(B, T, H, D, window, lengths):
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, T, H, D, seed=T + D))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = _k1_emulation(q, k, v, lens, window)
    assert not torch.isnan(got).any()  # every row written once
    ref = banded_attention(q, k, v, lens, window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,KVH,G,HD,cdt", [
    (3, 40, 2, 6, 64, np.float32),
    (2, 33, 2, 6, 64, "bf16"),
    (1, 16, 4, 3, 64, np.float32),
])
def test_decode_attention_matches_pallas_interpret(B, S, KVH, G, HD, cdt):
    rng = np.random.RandomState(0)
    q = rng.randn(B, KVH, G, HD).astype(np.float32)
    kc, vc = (rng.randn(B, KVH, HD).astype(np.float32) for _ in range(2))
    ck, cv = (rng.randn(B, S, KVH, HD).astype(np.float32) for _ in range(2))
    pos = rng.randint(0, S, B).astype(np.int32)
    pos[0] = 0  # an empty-cache lane attends to its current token alone
    scale = 1.0 / np.sqrt(HD)
    jdt = jnp.bfloat16 if cdt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cdt == "bf16" else torch.float32
    ref = decode_attention_pallas(
        jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(x, jdt) for x in (kc, vc, ck, cv)),
        scale, jnp.asarray(pos), out_dtype=jnp.float32, interpret=True)
    # q reaches the JAX kernel as bf16, like the decode step's q
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = decode_attention(tq.to(tdt), *(torch.from_numpy(x).to(tdt) for x in (kc, vc, ck, cv)),
                           scale, torch.from_numpy(pos))
    tol = 2e-2 if cdt == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=0)


def _k2_split_emulation(q, k_cur, v_cur, cache_k, cache_v, scale, pos, cdt):
    """Kernel K2's algorithm in float32 torch: the cache cut into the
    launch_shape ranges, each range's (max, sum of exp), the global max and
    sum (ranges in rank order, then the current token), probabilities
    rounded to the cache dtype after normalization, each range's f32
    partial P.V, the partials summed in rank order, the current token's
    term rounded as decode_attention_xla rounds it."""
    B, S, KVH, HD = cache_k.shape
    n_split, lanes, R = k2.launch_shape(B, S, KVH)
    assert lanes == B * KVH and n_split * R >= S
    qf = q.float()
    s_cur = torch.einsum("bngd,bnd->bng", qf, k_cur.float()) * scale  # [B, KVH, G]
    out = torch.empty(q.shape, dtype=cdt)
    for b in range(B):
        P = min(max(int(pos[b]), 0), S)
        ranges = [(r * R, max(r * R, min((r + 1) * R, P))) for r in range(n_split)]
        scores = [torch.einsum("ngd,snd->ngs", qf[b], cache_k[b, lo:hi].float()) * scale
                  for lo, hi in ranges]
        m = [sc.amax(-1) if sc.shape[-1] else torch.full(s_cur[b].shape, -np.inf)
             for sc in scores]
        l = [torch.exp(sc - mr[..., None]).sum(-1) for sc, mr in zip(scores, m)]
        M = torch.maximum(torch.stack(m).amax(0), s_cur[b])
        L = torch.zeros_like(M)
        for mr, lr in zip(m, l):
            L = L + torch.where(mr > -np.inf, lr * torch.exp(mr - M), torch.zeros(()))
        L = L + torch.exp(s_cur[b] - M)
        att = torch.zeros(q.shape[1:], dtype=torch.float32)
        for (lo, hi), sc in zip(ranges, scores):
            p = (torch.exp(sc - M[..., None]) / L[..., None]).to(cdt).float()
            att = att + torch.einsum("ngs,snd->ngd", p, cache_v[b, lo:hi].float())
        p_cur = (torch.exp(s_cur[b] - M) / L).to(cdt)
        out[b] = att.to(cdt) + p_cur[..., None] * v_cur[b, :, None, :].to(cdt)
    return out.reshape(B, -1)


# the 0.1B LLM's decode shape; one lane each at pos 0, 1, the first range
# edge, S - 1 and S
@pytest.mark.parametrize("S", [33, 700])
@pytest.mark.parametrize("cdt", [np.float32, "bf16"])
def test_decode_attention_split_emulation(S, cdt):
    B, KVH, G, HD = 5, 2, 6, 64
    R = k2.launch_shape(B, S, KVH)[2]
    rng = np.random.RandomState(S)
    q = rng.randn(B, KVH, G, HD).astype(np.float32)
    kc, vc = (rng.randn(B, KVH, HD).astype(np.float32) for _ in range(2))
    ck, cv = (rng.randn(B, S, KVH, HD).astype(np.float32) for _ in range(2))
    pos = np.array([0, 1, R, S - 1, S], np.int32)
    scale = 1.0 / np.sqrt(HD)
    jdt = jnp.bfloat16 if cdt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cdt == "bf16" else torch.float32
    ref = np.asarray(decode_attention_pallas(
        jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(x, jdt) for x in (kc, vc, ck, cv)),
        scale, jnp.asarray(pos), out_dtype=jnp.float32, interpret=True), np.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16).to(tdt)
    args = (tq, *(torch.from_numpy(x).to(tdt) for x in (kc, vc, ck, cv)), scale,
            torch.from_numpy(pos))
    got = _k2_split_emulation(*args, tdt).float().numpy()
    plain = decode_attention_plain(*args).float().numpy()
    tol = 2e-2 if cdt == "bf16" else 1e-5
    np.testing.assert_allclose(got, plain, atol=tol, rtol=0)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("B,S,KVH", [(1, 700, 2), (8, 700, 2), (1, 33, 2), (3, 1, 4),
                                     (2, 9, 1), (1, 4096, 2)])
def test_decode_attention_launch_shape(B, S, KVH):
    """One cluster of 8 blocks per (lane, kv head); the ranges cover every
    cache row exactly once, and clipped to [0, pos) they cover [0, pos)
    exactly once for every pos: the grid depends on S, B and KVH only."""
    n_split, lanes, R = k2.launch_shape(B, S, KVH)
    assert (n_split, lanes) == (k2.SPLIT, B * KVH) == (8, B * KVH)
    for P in sorted({0, 1, R - 1, R, R + 1, S - 1, S} & set(range(S + 1))):
        hits = np.zeros(S, np.int64)
        for r in range(n_split):
            hits[r * R:max(r * R, min((r + 1) * R, P))] += 1
        assert (hits[:P] == 1).all() and (hits[P:] == 0).all()
