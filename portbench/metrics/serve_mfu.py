"""serve_mfu: the model FLOPs of every prompt position prefilled and
every token decoded in the serving window before its profiler starts,
per host second, over the int8 dense peak, in percent."""

from portbench.harness import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return readers.mfu(ctx, "serve", ctx["got"].get("mfu_flops", 0.0))
