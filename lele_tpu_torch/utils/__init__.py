"""Host utilities of the port (counterpart of lele_tpu.utils): CTC decoding,
the tokenizer, WAV IO and image preprocessing."""
