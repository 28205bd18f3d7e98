"""The dropless expert layer's dispatch: the permutation of routed rows
into expert order and the gated combine back (``ops``)."""
