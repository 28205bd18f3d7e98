"""train_tokens_per_s: every token of every step finished in the window
(all dp ranks' rows), over the window's wall time between two device
syncs."""


def read(run):
    return run["window_steps"] * run["tokens_per_step"] / run["window_s"]
