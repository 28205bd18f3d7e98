"""The port's versions of the paper's claim benchmarks: the compression
block-size ablation, Adam's variance stabilisation (Fig. 2 and the
Sec. 7.1 rule) and sample-wise convergence parity (Fig. 1, 4, 6).  Each
runs on the card unless asked for the CPU (``--device cpu``)."""
