"""comm.dp_wire_mb: MB (1e6 bytes) a step of the tensors a rank hands to
``torch.distributed`` calls on its dp group, counted at the call, the
largest over the ranks."""


def read(run):
    traced = run.get("traced")
    if not traced:
        return None
    vals = [t["wire_bytes_per_step"].get("dp") for t in traced]
    vals = [v for v in vals if v]
    return max(vals) / 1e6 if vals else None
