"""The port's converters (miotts_tpu_torch/converters/) against the JAX
package's (miotts_tpu/convert/ and scripts/convert_preset_embedding_to_gguf.py):
the synthetic MioCodec checkpoints of tests/test_converters.py (wave, with
and without the 44.1 kHz-style upsampler, dynamic and static-preset), a
mel-mode checkpoint with its postnet and bundled vocoder, the synthetic
WavLM Base+ checkpoint and .pt/.npz presets give byte-equal GGUFs;
``requantize_gguf`` writes byte-equal files for each target; and a
port-converted codec decodes in the port as the JAX-converted one decodes
in JAX (tests/test_converters.py's tolerance, rtol 1e-3 / atol 1e-4)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import load_file, save_file

from miotts_tpu.convert.miocodec import _load_embedding as jax_load_embedding
from miotts_tpu.convert.miocodec import convert_miocodec as jax_convert_miocodec
from miotts_tpu.convert.quantize import requantize_gguf as jax_requantize
from miotts_tpu.convert.wavlm import convert_wavlm as jax_convert_wavlm
from miotts_tpu.gguf.writer import save_embedding_gguf as jax_save_embedding
from miotts_tpu.models.miocodec import codec_decode_spec as jax_decode_spec
from miotts_tpu.models.miocodec import load_miocodec as jax_load_miocodec
from miotts_tpu.testing import write_synthetic_llm_gguf
from test_converters import _make_codec_checkpoint

from miotts_tpu_torch.converters import miocodec, preset_embedding, quantize, wavlm
from miotts_tpu_torch.models.miocodec import codec_decode_spec, load_miocodec

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPEC_RTOL, SPEC_ATOL = 1e-3, 1e-4  # tests/test_converters.py


def _emb(rng) -> np.ndarray:
    return (rng.randn(12) * 0.5).astype(np.float32)


def _mel_checkpoint(tmp_path, rng) -> tuple[str, str]:
    """tests/test_converters.py's wave checkpoint made mel-mode: its prenet,
    upsample and decoder renamed to the mel ones, the decoder's output
    projection to 10 mels, a 2-layer mel postnet and a 2-stage vocoder
    (weight-normed convs, 2 resblocks a stage of kernels 3 and 5)."""
    cfg_path, weights_path = _make_codec_checkpoint(tmp_path, rng)
    sd = {}
    for k, v in load_file(weights_path).items():
        if k.startswith(("wave_prior_net.", "wave_post_net.", "istft_head.")):
            continue
        for src, dst in (("wave_prenet.", "mel_prenet."), ("wave_decoder.", "mel_decoder."),
                         ("wave_conv_upsample.", "mel_conv_upsample.")):
            if k.startswith(src):
                k = dst + k[len(src):]
        sd[k] = v

    def t(*shape, scale=0.1):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32)

    n_mels, dd, ch, rates, kernels = 10, 8, 6, (4, 2), (3, 5)
    sd["mel_decoder.output_proj.weight"] = t(n_mels, dd, scale=0.2)
    sd["mel_decoder.output_proj.bias"] = t(n_mels, scale=0.02)
    for i in range(2):
        sd[f"mel_postnet.convolutions.{i}.0.weight"] = t(n_mels, n_mels, 5)
        sd[f"mel_postnet.convolutions.{i}.0.bias"] = t(n_mels, scale=0.02)
        sd[f"mel_postnet.convolutions.{i}.1.norm.weight"] = 1.0 + t(n_mels, scale=0.02)
        sd[f"mel_postnet.convolutions.{i}.1.norm.bias"] = t(n_mels, scale=0.02)

    def wn(name, cout, cin, k, bias=True):
        sd[f"vocoder.model.{name}.weight_g"] = 1.0 + t(cout, 1, 1, scale=0.1)
        sd[f"vocoder.model.{name}.weight_v"] = t(cout, cin, k, scale=0.3)
        if bias:
            sd[f"vocoder.model.{name}.bias"] = t(cout, scale=0.02)

    filt = np.hanning(14)[1:-1].astype(np.float32)
    filt = torch.tensor(filt / filt.sum()).reshape(1, 1, -1)

    def act(prefix):
        sd[f"{prefix}.act.alpha"] = t(ch)
        sd[f"{prefix}.act.beta"] = t(ch)
        sd[f"{prefix}.upsample.filter"] = filt.clone()
        sd[f"{prefix}.downsample.lowpass.filter"] = filt.clone()

    wn("conv_pre", ch, n_mels, 7)
    wn("conv_post", 1, ch, 7, bias=False)
    for i in range(len(rates)):
        wn(f"ups.{i}.convolution_after", ch, ch, 1)
        wn(f"ups.{i}.convolution_noise", ch, ch, 7)
    for r in range(len(rates) * len(kernels)):
        for c in range(3):
            wn(f"resblocks.{r}.convs1.{c}", ch, ch, kernels[r % len(kernels)])
            wn(f"resblocks.{r}.convs2.{c}", ch, ch, kernels[r % len(kernels)])
        for a in range(6):
            act(f"vocoder.model.resblocks.{r}.activations.{a}")
    act("vocoder.model.activation_post")

    mel_weights = tmp_path / "mel.safetensors"
    save_file(sd, str(mel_weights))
    config = yaml.safe_load(open(cfg_path))
    model = config["model"]["init_args"]
    model["config"].update(use_wave_decoder=False, n_mels=n_mels)
    model["mel_prenet"] = model.pop("wave_prenet")
    model["mel_decoder"] = model.pop("wave_decoder")
    mel_cfg = tmp_path / "mel_config.yaml"
    mel_cfg.write_text(yaml.safe_dump(config))
    return str(mel_cfg), str(mel_weights)


# (checkpoint, upsampler, static preset, convert_miocodec keyword arguments)
CODEC_CASES = {
    "wave_dynamic": ("wave", False, None, {}),
    "wave_static_npz": ("wave", False, "npz", {}),
    "wave_static_pt": ("wave", False, "pt", {}),
    "wave_upsampler": ("wave", True, None, dict(samples_per_token=32)),
    "wave_upsampler_static": ("wave", True, "npz", dict(samples_per_token=32)),
    "mel_dynamic": ("mel", False, None, dict(samples_per_token=32,
                                             vocoder_upsample_rates=(4, 2))),
    "mel_static": ("mel", False, "pt", dict(samples_per_token=32,
                                            vocoder_upsample_rates=(4, 2))),
}


def _preset(tmp_path, rng, kind: str) -> str:
    emb = _emb(rng)
    if kind == "npz":
        path = tmp_path / "emb.npz"
        np.savez(path, global_embedding=emb)
    else:
        path = tmp_path / "emb.pt"
        torch.save({"global_embedding": torch.from_numpy(emb)}, path)
    return str(path)


@pytest.fixture(scope="module", params=sorted(CODEC_CASES))
def converted(request, tmp_path_factory):
    """One checkpoint through both converters: (case, JAX GGUF, port GGUF,
    JAX summary, port summary)."""
    case = request.param
    kind, ups, preset, kw = CODEC_CASES[case]
    d = tmp_path_factory.mktemp(case)
    rng = np.random.RandomState(sorted(CODEC_CASES).index(case))
    if kind == "mel":
        cfg, weights = _mel_checkpoint(d, rng)
    else:
        cfg, weights = _make_codec_checkpoint(d, rng, with_upsampler=ups)
    kw = dict(kw, dynamic_global=preset is None)
    if preset:
        kw["preset_embedding"] = _preset(d, rng, preset)
    jax_path, port_path = d / "jax.gguf", d / "port.gguf"
    js = jax_convert_miocodec(cfg, weights, str(jax_path), **kw)
    ps = miocodec.convert_miocodec(cfg, weights, str(port_path), **kw)
    return case, jax_path, port_path, js, ps


def test_miocodec_gguf_byte_equal(converted):
    case, jax_path, port_path, js, ps = converted
    assert jax_path.read_bytes() == port_path.read_bytes()
    assert {**js, "outfile": None} == {**ps, "outfile": None}
    kind, ups, preset, _ = CODEC_CASES[case]
    assert (ps["model_type"], ps["has_wave_upsampler"], ps["has_vocoder"],
            ps["dynamic_global_embedding"]) == (kind, ups, kind == "mel", preset is None)


def test_port_converted_codec_decodes_as_jax(converted):
    """The port decodes its own GGUF as JAX decodes its own: the spectrogram
    and the frame count of 7 random codes, with the embedding the static
    export folded in (or any, for a dynamic one)."""
    case, jax_path, port_path, _, _ = converted
    rng = np.random.RandomState(40)
    codes = rng.randint(0, 12800, 7).astype(np.int32)
    jcfg, jw = jax_load_miocodec(str(jax_path))
    cfg, w = load_miocodec(str(port_path), CPU)
    cond = _emb(rng)[None] if cfg.dynamic_global else None
    spec_j, fl_j = jax.jit(jax_decode_spec, static_argnums=0)(
        jcfg, jax.tree.map(jnp.asarray, jw), jnp.asarray(codes)[None],
        jnp.asarray([7], jnp.int32), None if cond is None else jnp.asarray(cond))
    spec, fl = codec_decode_spec(cfg, w, torch.from_numpy(codes.astype(np.int64))[None],
                                 torch.tensor([7], dtype=torch.int32),
                                 None if cond is None else torch.from_numpy(cond),
                                 matmul="float32")
    f = int(fl_j[0])
    assert int(fl[0]) == f and np.isfinite(spec.numpy()).all()
    np.testing.assert_allclose(spec[0, :f].numpy(), np.array(spec_j[0, :f]),
                               rtol=SPEC_RTOL, atol=SPEC_ATOL)


def test_static_preset_agrees_with_dynamic(tmp_path):
    """tests/test_converters.py's parity check on the port's side: the
    static export (AdaLN folded at conversion) decodes as the dynamic one
    conditioned at run time with the same embedding."""
    rng = np.random.RandomState(0)
    cfg_path, weights_path = _make_codec_checkpoint(tmp_path, rng)
    miocodec.convert_miocodec(cfg_path, weights_path, str(tmp_path / "dyn.gguf"))
    emb = _emb(rng)
    np.savez(tmp_path / "emb.npz", global_embedding=emb)
    miocodec.convert_miocodec(cfg_path, weights_path, str(tmp_path / "static.gguf"),
                              dynamic_global=False,
                              preset_embedding=str(tmp_path / "emb.npz"))
    dcfg, dw = load_miocodec(str(tmp_path / "dyn.gguf"), CPU)
    scfg, sw = load_miocodec(str(tmp_path / "static.gguf"), CPU)
    assert dcfg.dynamic_global and not scfg.dynamic_global and dcfg.vocab_size == 12800
    tokens = torch.from_numpy(rng.randint(0, 12800, 7).astype(np.int64))[None]
    lengths = torch.tensor([7], dtype=torch.int32)
    spec_d, fl_d = codec_decode_spec(dcfg, dw, tokens, lengths, torch.from_numpy(emb)[None],
                                     matmul="float32")
    spec_s, fl_s = codec_decode_spec(scfg, sw, tokens, lengths, None, matmul="float32")
    f = int(fl_d[0])
    assert int(fl_s[0]) == f
    np.testing.assert_allclose(spec_d[0, :f].numpy(), spec_s[0, :f].numpy(),
                               rtol=SPEC_RTOL, atol=SPEC_ATOL)


def _wavlm_checkpoint(path, rng, n_layers: int = 3) -> None:
    """tests/test_converters.py's synthetic torchaudio WavLM Base+ state
    dict (Base+ widths, 3 transformer layers)."""
    def t(*shape, scale=0.1):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32)

    sd = {"feature_extractor.conv_layers.0.layer_norm.weight": 1.0 + t(512, scale=0.02),
          "feature_extractor.conv_layers.0.layer_norm.bias": t(512, scale=0.02),
          "feature_extractor.conv_layers.0.conv.weight": t(512, 1, 10, scale=0.2)}
    for i, k in enumerate([3, 3, 3, 3, 2, 2], start=1):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = t(512, 512, k, scale=0.05)
    sd["encoder.feature_projection.layer_norm.weight"] = 1.0 + t(512, scale=0.02)
    sd["encoder.feature_projection.layer_norm.bias"] = t(512, scale=0.02)
    sd["encoder.feature_projection.projection.weight"] = t(768, 512, scale=0.05)
    sd["encoder.feature_projection.projection.bias"] = t(768, scale=0.02)
    sd["encoder.transformer.layer_norm.weight"] = 1.0 + t(768, scale=0.02)
    sd["encoder.transformer.layer_norm.bias"] = t(768, scale=0.02)
    sd["encoder.transformer.pos_conv_embed.conv.weight_v"] = t(768, 48, 128, scale=0.05)
    sd["encoder.transformer.pos_conv_embed.conv.weight_g"] = 1.0 + t(1, 1, 128, scale=0.05)
    sd["encoder.transformer.pos_conv_embed.conv.bias"] = t(768, scale=0.02)
    for i in range(n_layers):
        s = f"encoder.transformer.layers.{i}"
        sd[f"{s}.attention.attention.in_proj_weight"] = t(3 * 768, 768, scale=0.05)
        sd[f"{s}.attention.attention.in_proj_bias"] = t(3 * 768, scale=0.02)
        sd[f"{s}.attention.attention.out_proj.weight"] = t(768, 768, scale=0.05)
        sd[f"{s}.attention.attention.out_proj.bias"] = t(768, scale=0.02)
        sd[f"{s}.attention.gru_rel_pos_linear.weight"] = t(8, 64, scale=0.1)
        sd[f"{s}.attention.gru_rel_pos_linear.bias"] = t(8, scale=0.05)
        sd[f"{s}.attention.gru_rel_pos_const"] = t(1, 12, 1, 1, scale=0.3)
        sd[f"{s}.layer_norm.weight"] = 1.0 + t(768, scale=0.02)
        sd[f"{s}.layer_norm.bias"] = t(768, scale=0.02)
        sd[f"{s}.final_layer_norm.weight"] = 1.0 + t(768, scale=0.02)
        sd[f"{s}.final_layer_norm.bias"] = t(768, scale=0.02)
        sd[f"{s}.feed_forward.intermediate_dense.weight"] = t(3072, 768, scale=0.03)
        sd[f"{s}.feed_forward.intermediate_dense.bias"] = t(3072, scale=0.02)
        sd[f"{s}.feed_forward.output_dense.weight"] = t(768, 3072, scale=0.03)
        sd[f"{s}.feed_forward.output_dense.bias"] = t(768, scale=0.02)
    sd["encoder.transformer.layers.0.attention.rel_attn_embed.weight"] = t(320, 12, scale=0.2)
    torch.save({"model": sd}, str(path))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_wavlm_gguf_byte_equal(tmp_path, n_layers):
    ckpt = tmp_path / "wavlm_base_plus.pth"
    _wavlm_checkpoint(ckpt, np.random.RandomState(2))
    js = jax_convert_wavlm(str(ckpt), str(tmp_path / "jax.gguf"), n_layers)
    rc = wavlm.main(["--wavlm-weights", str(ckpt), "--num-transformer-layers", str(n_layers),
                     "-o", str(tmp_path / "port.gguf")])
    assert rc == 0 and js["n_layers"] == n_layers
    assert (tmp_path / "jax.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_preset_embedding_byte_equal(tmp_path, kind, capsys):
    """The preset converter (scripts/convert_preset_embedding_to_gguf.py: the
    JAX package's _load_embedding and embedding writer) against the port's
    command line."""
    path = _preset(tmp_path, np.random.RandomState(3), kind)
    jax_save_embedding(str(tmp_path / "jax.emb.gguf"), jax_load_embedding(Path(path)))
    assert preset_embedding.main([path, "-o", str(tmp_path / "port.emb.gguf")]) == 0
    assert json.loads(capsys.readouterr().out)["embedding_dim"] == 12
    assert (tmp_path / "jax.emb.gguf").read_bytes() == (tmp_path / "port.emb.gguf").read_bytes()


def test_miocodec_main_matches_converter(tmp_path, capsys):
    """The command line (CODEC_DIR and the flags' defaults) writes what
    convert_miocodec writes."""
    rng = np.random.RandomState(4)
    cfg, weights = _make_codec_checkpoint(tmp_path, rng)
    jax_convert_miocodec(cfg, weights, str(tmp_path / "jax.gguf"))
    assert miocodec.main([str(tmp_path), "-o", str(tmp_path / "port.gguf")]) == 0
    assert json.loads(capsys.readouterr().out)["model_type"] == "wave"
    assert (tmp_path / "jax.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()


# (source quantization, target): tests/test_quantize_tool.py's two and f32 -> q8_0
@pytest.mark.parametrize("source, target", [("f32", "q4_0"), ("q8_0", "q4_0"), ("f32", "q8_0")])
def test_requantize_byte_equal(tmp_path, source, target):
    src = tmp_path / "src.gguf"
    write_synthetic_llm_gguf(str(src), n_audio=96, seed=7,
                             **({} if source == "f32" else {"quant": source}))
    want = jax_requantize(src, tmp_path / "jax.gguf", target)
    got = quantize.requantize_gguf(src, tmp_path / "port.gguf", target)
    assert got == want and got.get(target.upper(), 0) > 0
    assert (tmp_path / "jax.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()


def test_quantize_main(tmp_path, capsys):
    src = tmp_path / "src.gguf"
    write_synthetic_llm_gguf(str(src), n_audio=96, seed=7)
    jax_requantize(src, tmp_path / "jax.gguf", "q4_0")
    assert quantize.main([str(src), str(tmp_path / "port.gguf")]) == 0
    assert "x Q4_0" in capsys.readouterr().out
    assert (tmp_path / "jax.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()
    with pytest.raises(ValueError):
        quantize.requantize_gguf(src, tmp_path / "x.gguf", "q5_0")
