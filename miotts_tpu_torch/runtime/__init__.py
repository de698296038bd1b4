"""Host-side runtime pieces of the port (miotts_tpu/runtime/): the BPE
tokenizer, code and WAV I/O, the mel-L1 fidelity metric (numpy only), the
packed weight upload (``device_dequant.py``) and the native CPU engine's
C++ GEMVs (``native.py``, built by ``build_native.py``)."""
