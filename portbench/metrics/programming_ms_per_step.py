"""programming_ms_per_step: device milliseconds of the kernels inside the
benchmark's profiler ranges around `core.aimc.program_stacked` (the
crossbar programming of every straight-through call, its noise draws
included), per training step."""

from portbench.harness import readers


def read(ctx):
    tr = readers.traced(ctx, "train")
    if tr is None or not tr["by_range_s"].get("pb.program"):
        return None
    return 1e3 * tr["by_range_s"]["pb.program"] / ctx["got"]["steps"]
