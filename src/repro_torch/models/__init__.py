"""The model at tp=1: every family's training forward over a flat
parameter vector (the BERT encoder, the dense, MoE, Mamba-1 SSM and Jamba
hybrid decoders, the audio and VLM input stubs), and the dense decoders'
prefill and KV-cached decode."""
