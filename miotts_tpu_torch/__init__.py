"""miotts_tpu_torch — the PyTorch/CUDA port of miotts_tpu.

The JAX package ``miotts_tpu`` is the reference; module names here mirror
it (``ops/attention.py`` <- ``miotts_tpu/ops/attention.py`` and so on) so a
reader finds each counterpart at once. This package imports ``torch`` and
never ``jax``, and nothing of ``miotts_tpu``: the jax-free host modules it
needs (``gguf/``, ``runtime/{tokenizer,codes_io,audio_io,metrics}.py``,
the CLI's parser) are its own copies.

The Pallas kernels of the reference become hand-written CUDA C++ kernels
for Hopper (``csrc/``), built at first use by ``ops/cuda/build.py``.
"""

MIO_CODE_MIN = 0
MIO_CODE_MAX = 12799  # reference: src/mio-tts-lib.cpp:30-31
