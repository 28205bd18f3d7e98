"""device.idle_share: percent of a step's wall time with no device
operation running, on the rank with the least device time: one minus the
traced steps' device busy seconds a step (the union of the device
operations' intervals) over the measured window's seconds a step.  The
measured window's and not the traced steps' wall: the profiler's host
cost a recorded op stretches the traced steps' wall, not their device
work."""


def read(run):
    traced = run.get("traced")
    if not traced or not all(t["busy_s"] > 0 and t["steps"]
                             for t in traced):
        return None
    step_s = run["window_s"] / run["window_steps"]
    busy = min(t["busy_s"] / t["steps"] for t in traced)
    return 100.0 * (1.0 - busy / step_s)
