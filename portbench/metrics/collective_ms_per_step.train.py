"""Device milliseconds a step in NCCL's kernels on rank 0 (the Mesh layer's
gradient all-reduce); nothing to read off a mesh."""


def read(ctx):
    if not ctx.get("mesh") or "device_s_by_name" not in ctx:
        return None
    nccl = sum(s for name, s in ctx["device_s_by_name"].items() if "nccl" in name.lower())
    return nccl / ctx["units"] * 1e3
