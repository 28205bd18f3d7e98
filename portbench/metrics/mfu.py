"""mfu: model FLOPs a step (``flops/<config>.py``: no recompute) times
the window's steps, over its seconds, over the cards' bf16 peak (the data
sheet's 989 TFLOP/s each), in percent.  The rate is the measured
window's, outside the profiled steps."""


def read(run):
    peak = run["chips"] * run["peaks"]["bf16_flops"]
    return 100.0 * run["step_flops"] * run["window_steps"] \
        / run["window_s"] / peak
