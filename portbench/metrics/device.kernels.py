"""device.kernels: kernels launched a traced step, the most on any
rank."""


def read(run):
    traced = run.get("traced")
    if not traced:
        return None
    n = max(len(t["kernels"]) / t["steps"] for t in traced if t["steps"])
    return n or None
