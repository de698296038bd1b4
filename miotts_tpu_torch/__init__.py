"""miotts_tpu_torch — the PyTorch/CUDA port of miotts_tpu.

The JAX package ``miotts_tpu`` is the reference; module names here mirror
it (``ops/attention.py`` <- ``miotts_tpu/ops/attention.py`` and so on) so a
reader finds each counterpart at once. This package imports ``torch`` and
never ``jax``: the only ``miotts_tpu`` modules it uses are the jax-free host
modules (``gguf``, ``runtime.tokenizer``, ``runtime.audio_io``,
``runtime.codes_io`` and ``cli.build_parser``).

The Pallas kernels of the reference become hand-written CUDA C++ kernels
for Hopper (``csrc/``), built at first use by ``ops/cuda/build.py``.
"""
