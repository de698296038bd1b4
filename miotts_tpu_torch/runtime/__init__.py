"""Host-side runtime pieces of the port (miotts_tpu/runtime/): the BPE
tokenizer, code and WAV I/O, and the mel-L1 fidelity metric. numpy only."""
