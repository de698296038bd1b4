"""Checkpoint -> GGUF converters and the GGUF requantizer
(miotts_tpu/convert/), each with the command line of its script in
``scripts/``:

    python -m miotts_tpu_torch.converters.miocodec CODEC_DIR -o codec.gguf
    python -m miotts_tpu_torch.converters.wavlm --wavlm-weights wavlm_base_plus.pth -o wavlm.gguf
    python -m miotts_tpu_torch.converters.preset_embedding preset.pt -o voice.emb.gguf
    python -m miotts_tpu_torch.converters.quantize src.gguf dst.gguf q8_0

They emit the tensor contract of the reference converters through the
port's own GGUF writer, byte for byte what the JAX package's converters
write. Host code: numpy math; ``yaml`` and ``safetensors`` (MioCodec
checkpoints) and ``torch`` (``.pt`` checkpoints) are imported only to
read a checkpoint.
"""
