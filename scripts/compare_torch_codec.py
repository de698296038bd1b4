#!/usr/bin/env python3
"""Whether two trees' mesh-less codec decodes are bit-equal.

    python3 scripts/compare_torch_codec.py --save DIR      # in tree A
    python3 scripts/compare_torch_codec.py --compare DIR   # in tree B

Writes small synthetic codecs (the 24 kHz wave codec, one with a 2x2 wave
upsampler, a mel codec with its vocoder; ``testing.tiny_codec_config``)
into DIR, decodes 33 and 137 codes of each through ``MioTTSPipeline``
(peak-normalized, and as a stream's windowed prefix decode with an anchor)
and saves the audio as DIR/codec_bits.npz; ``--compare`` decodes the same
GGUFs and reports, for each decode, whether its audio is bit-equal to the
saved one (exit 1 if any is not). ``MIOTTS_PLATFORM`` picks the device
(cpu or cuda).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.pipeline import MioTTSPipeline  # noqa: E402
from miotts_tpu_torch.testing import (  # noqa: E402
    tiny_codec_config, write_synthetic_mel_vocoder_gguf, write_synthetic_miocodec_gguf)

CODECS = {
    "wave": lambda p: write_synthetic_miocodec_gguf(p, tiny_codec_config(), seed=0),
    "ups": lambda p: write_synthetic_miocodec_gguf(p, tiny_codec_config(
        wave_upsampler_factors=(2, 2), wave_upsampler_kernel_sizes=(4, 4)), seed=0),
    "mel": lambda p: write_synthetic_mel_vocoder_gguf(p, tiny_codec_config(
        model_type=1, n_mels=12, n_fft=64, hop_length=16, samples_per_token=32, resnet_blocks=0,
        vocoder_upsample_rates=(4, 2, 2), vocoder_num_kernels=2), seed=0),
}


def decodes(d: Path) -> dict[str, np.ndarray]:
    device = select_device()
    rng = np.random.default_rng(0)
    out = {}
    for name, write in CODECS.items():
        path = d / f"{name}.gguf"
        if not path.exists():
            write(str(path))
        pipe = MioTTSPipeline(path, device)
        for n in (33, 137):
            codes = rng.integers(0, 128, n)
            emb = (rng.standard_normal(16) * 0.1).astype(np.float32)
            out[f"{name} {n}"] = pipe.synthesize(codes, emb).audio
            out[f"{name} {n} window"] = pipe.synthesize(
                codes, emb, window=(100, 300), peak_normalize=False, interp_anchor=50).audio
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="DIR")
    mode.add_argument("--compare", metavar="DIR")
    args = ap.parse_args()
    d = Path(args.save or args.compare)
    d.mkdir(parents=True, exist_ok=True)
    got = decodes(d)
    if args.save:
        np.savez(d / "codec_bits.npz", **got)
        print(f"saved {len(got)} decodes on {os.environ.get('MIOTTS_PLATFORM', 'cuda')}")
        return 0
    saved = np.load(d / "codec_bits.npz")
    bad = [k for k in got if k not in saved or got[k].tobytes() != saved[k].tobytes()]
    for k in got:
        print(f"{k}: {'bit-equal' if k not in bad else 'DIFFERS'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
