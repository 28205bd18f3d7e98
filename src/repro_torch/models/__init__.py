"""The BERT encoder (slice 1) as an nn.Module over a flat parameter vector."""
