"""The transformer at tp=1: the BERT encoder (slice 1, training over a flat
parameter vector) and the dense decoders (slice 2, prefill and KV-cached
decode)."""
