"""train_mfu: the model FLOPs of the whole steps a traced run times on
the host clock before its profiler starts (3x the forward of every
token, attention scores included, no recompute; `harness/counts.py`) per
second over the int8 dense peak, in percent."""

from portbench.harness import counts, readers


def read(ctx):
    got, t = ctx["got"], ctx["cell"].traffic
    if ctx["kind"] != "train" or not got.get("mfu_steps"):
        return None
    flops = got["mfu_steps"] * counts.train_step_flops(
        ctx["cell"].config, t["global_batch"], t["seq_len"])
    return readers.mfu(ctx, "train", flops)
