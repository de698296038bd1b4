"""Port ops (miotts_tpu_torch.ops) against the JAX ops at f32 on the CPU:
masking, norms, RoPE (NORM and NEOX), convs and the iSTFT, with ragged
lengths. Tolerance atol 1e-5 (f32, sums in another order); values at
t >= length must be exactly 0 where the JAX op guarantees it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.ops import convs as jconvs
from miotts_tpu.ops import istft as jistft
from miotts_tpu.ops import masking as jmask
from miotts_tpu.ops import norms as jnorms
from miotts_tpu.ops import rope as jrope
from miotts_tpu_torch.ops import convs, istft, masking, norms, rope

torch.set_num_threads(1)

ATOL = 1e-5
LENGTHS = np.array([37, 20, 1], np.int32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0)


def _zero_past(t, lengths):
    t = np.asarray(t)
    for b, n in enumerate(lengths):
        assert np.all(t[b, n:] == 0), f"lane {b}: nonzero past length {n}"


def test_masking():
    x = np.random.RandomState(0).randn(3, 37, 5).astype(np.float32)
    (jx, tx), (jl, tl) = _both(x), _both(LENGTHS)
    assert np.array_equal(np.asarray(jmask.time_mask(37, jl)), masking.time_mask(37, tl).numpy())
    out = masking.mask_time(tx, tl)
    _close(jmask.mask_time(jx, jl), out, atol=0)
    _zero_past(out, LENGTHS)


def test_layer_norm_and_adaln():
    rng = np.random.RandomState(1)
    x, wgt, b = rng.randn(3, 11, 24), rng.randn(24), rng.randn(24)
    shift, scale = rng.randn(3, 24), rng.randn(3, 24)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a.astype(np.float32)) for a in (x, wgt, b))
    _close(jnorms.layer_norm(jx, jw, jb, eps=1e-5), norms.layer_norm(tx, tw, tb, eps=1e-5))
    _close(jnorms.layer_norm(jx), norms.layer_norm(tx))
    (js, ts), (jc, tc) = (_both(a.astype(np.float32)) for a in (shift, scale))
    _close(jnorms.adaln_modulate(jx, js, jc), norms.adaln_modulate(tx, ts, tc))


@pytest.mark.parametrize("groups", [1, 4, 32])
def test_masked_group_norm(groups):
    x = np.random.RandomState(2).randn(3, 37, 32).astype(np.float32)
    (jx, tx), (jl, tl) = _both(x), _both(LENGTHS)
    out = norms.masked_group_norm(tx, tl, groups, eps=1e-6)
    _close(jnorms.masked_group_norm(jx, jl, groups, eps=1e-6), out)
    _zero_past(out, LENGTHS)


@pytest.mark.parametrize("neox", [False, True])
@pytest.mark.parametrize("per_lane", [False, True])
def test_rope(neox, per_lane):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = (rng.randint(0, 500, (2, 9)) if per_lane else np.arange(9)).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    _close(jrope.apply_rope(jx, jp, 10000.0, neox=neox),
           rope.apply_rope(tx, tp, 10000.0, neox=neox), atol=ATOL)


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 1), (3, 2)])
def test_conv1d_same(k, dilation):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 37, 8).astype(np.float32)
    x[1, 20:] = 0
    x[2, 1:] = 0
    w, b = rng.randn(6, 8, k).astype(np.float32), rng.randn(6).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    _close(jconvs.conv1d_same(jx, jw, jb, dilation=dilation),
           convs.conv1d_same(tx, tw, tb, dilation=dilation))


def test_conv_transpose1d():
    rng = np.random.RandomState(5)
    x, w, b = rng.randn(2, 13, 8), rng.randn(8, 6, 4), rng.randn(6)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a.astype(np.float32)) for a in (x, w, b))
    out = convs.conv_transpose1d(tx, tw, tb, stride=2)
    assert out.shape == (2, (13 - 1) * 2 + 4, 6)
    _close(jconvs.conv_transpose1d(jx, jw, jb, stride=2), out)


@pytest.mark.parametrize("override", [None, (30, 64)])
def test_linear_interpolate(override):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 40, 5).astype(np.float32)
    src, dst = np.array([40, 23, 1], np.int32), np.array([80, 44, 2], np.int32)
    (jx, tx), (js, ts), (jd, td) = _both(x), _both(src), _both(dst)
    _close(jconvs.linear_interpolate(jx, js, jd, 80, scale_override=override),
           convs.linear_interpolate(tx, ts, td, 80, scale_override=override))


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (60, 16)])
def test_spec_to_audio(n_fft, hop):
    rng = np.random.RandomState(7)
    L = 12
    spec = (rng.randn(3, L, n_fft + 2) * 0.5).astype(np.float32)
    # log-magnitudes near -2 keep the audio O(1), where atol 1e-5 is ~10 ulp
    spec[..., : n_fft // 2 + 1] -= 2.0
    fl = np.array([12, 7, 1], np.int32)
    (jsp, tsp), (jfl, tfl) = _both(spec), _both(fl)
    tables = tuple(torch.from_numpy(t) for t in istft.dft_tables(n_fft))
    for a, b in zip(jistft._dft_tables(n_fft), istft.dft_tables(n_fft)):
        assert np.array_equal(a, b)
    out = istft.spec_to_audio(tsp, tfl, n_fft, hop, tables)
    _close(jistft.spec_to_audio(jsp, jfl, n_fft, hop), out)
