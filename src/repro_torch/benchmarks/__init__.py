"""The port's benchmarks, one module per paper table or figure, and the
harness that runs them (``run``: the reference's twelve names in its
order, ``--json`` into one ``BENCH_all.json``): the claims (convergence
parity, Fig. 1/4/6; the ResNet optimizer comparison, Sec. 7.2; the DCGAN
under 1-bit Adam, Sec. 7.3; Adam's variance stabilisation, Fig. 2; the
compression block-size ablation), the analytic Table 1 and Fig. 5
sweeps, and the system checks (kernel against plain, wire bytes against
the plans, the overlap of the pipelined exchange on the device, the
device and link calibrations).  Each runs on the card unless asked for
the CPU (``--device cpu``)."""
