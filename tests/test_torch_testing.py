"""The port's jax-free synthetic GGUF writers write the same KV metadata
and the same tensors (names, shapes, types, values) as miotts_tpu.testing
for the same seed."""

import dataclasses

import numpy as np
import pytest
import torch

from miotts_tpu import testing as jax_testing
from miotts_tpu.gguf import GGUFReader
from miotts_tpu_torch import testing

torch.set_num_threads(1)


def _same_gguf(a, b):
    with GGUFReader(a) as ra, GGUFReader(b) as rb:
        assert ra.kv == rb.kv
        assert list(ra.tensors) == list(rb.tensors)
        for name, info in ra.tensors.items():
            other = rb.tensors[name]
            assert (info.shape, info.ggml_type) == (other.shape, other.ggml_type), name
            assert np.array_equal(ra.tensor_raw(name), rb.tensor_raw(name)), name


@pytest.mark.parametrize("overrides,kwargs", [
    ({}, {}),
    ({}, {"with_global_encoder": False}),
    ({"dynamic_global": False}, {}),
    ({"samples_per_token": 64, "wave_upsampler_factors": (2,),
      "wave_upsampler_kernel_sizes": (4,)}, {}),
])
def test_codec_writer_matches(tmp_path, overrides, kwargs):
    jcfg = jax_testing.tiny_codec_config(**overrides)
    pcfg = testing.tiny_codec_config(**overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jax_testing.write_synthetic_miocodec_gguf(str(tmp_path / "j.gguf"), jcfg, seed=3, **kwargs)
    testing.write_synthetic_miocodec_gguf(str(tmp_path / "p.gguf"), pcfg, seed=3, **kwargs)
    _same_gguf(tmp_path / "j.gguf", tmp_path / "p.gguf")


def test_full_codec_config_matches():
    assert (dataclasses.asdict(testing.full_codec_config())
            == dataclasses.asdict(jax_testing.full_codec_config()))


@pytest.mark.parametrize("kwargs", [
    {},
    {"n_filler_vocab": 50, "audio_logit_scale": 3.0, "seed": 7},
    {"arch": "llama", "n_layers": 1, "quant": "f16"},
])
def test_llm_writer_matches(tmp_path, kwargs):
    jax_testing.write_synthetic_llm_gguf(str(tmp_path / "j.gguf"), **kwargs)
    testing.write_synthetic_llm_gguf(str(tmp_path / "p.gguf"), **kwargs)
    _same_gguf(tmp_path / "j.gguf", tmp_path / "p.gguf")
    assert testing.synthetic_vocab(8, 3) == jax_testing.synthetic_vocab(8, 3)
