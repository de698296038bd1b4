#!/usr/bin/env python3
"""Write the port's committed mp3 fixtures, tests/torch_assets/*.mp3, from
chip_smoke.py's clone clip (``clone_clip``, seed 21) through libmp3lame
(tests/mp3_oracles.lame_encode). A machine without libmp3lame (the card's)
reads the committed files instead of encoding them.

    python scripts/gen_torch_mp3_fixtures.py

- ``ref3.mp3``: the clip's first 3 s at 24 kHz mono, 64 kbps (MPEG-2), led
  by LAME's Info tag frame (tests/torch_lame.py), as a LAME file written
  with its VBR/Info tag on starts, then ``lame_encode``'s frames;
- ``ref20_441_joint.mp3``: 20 s of the clip at 44.1 kHz, joint stereo,
  128 kbps (MPEG-1), the right channel 0.9 of the left two samples later
  plus noise, so that LAME codes every frame mid/side; no tag frame.
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from mp3_oracles import lame_encode  # noqa: E402
from torch_lame import lame_stream  # noqa: E402

from chip_smoke import clone_clip  # noqa: E402

OUT = ROOT / "tests" / "torch_assets"
# (file, rate, seconds, channels, kbps, LAME's Info tag frame in front)
FIXTURES = (("ref3.mp3", 24000, 3.0, 1, 64, True),
            ("ref20_441_joint.mp3", 44100, 20.0, 2, 128, False))


def fixture(rate: int, secs: float, nch: int, kbps: int, tagged: bool) -> bytes:
    clip = clone_clip(rate, secs)
    if nch == 1:
        data = lame_encode(clip, rate, bitrate=kbps)
        if not tagged:
            return data
        # LAME's Info frame, then the very frames lame_encode writes
        tagged_data = lame_stream(clip, rate, kbps, info_tag=True)
        frame = tagged_data[:len(tagged_data) - len(data)]
        if frame + data != tagged_data or b"Info" not in frame:
            raise RuntimeError("LAME's tagged stream is not its Info frame + lame_encode's")
        return tagged_data
    rng = np.random.RandomState(17)
    right = 0.9 * np.roll(clip, 2) + 0.002 * rng.randn(clip.size)
    pcm = np.stack([clip, right.astype(np.float32)], 1)
    return lame_encode(pcm, rate, nch=2, bitrate=kbps, mode=1)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for name, rate, secs, nch, kbps, tagged in FIXTURES:
        data = fixture(rate, secs, nch, kbps, tagged)
        (OUT / name).write_bytes(data)
        print(f"wrote {OUT / name} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
