"""decode_step_ms.p50: the median host milliseconds between consecutive
decode-chunk readbacks of the engine, per decoded step (the benchmark's
wrapper around the chunk readback stamps each)."""

from portbench.harness import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return readers.median_ms(ctx["got"]["decode_step_s"])
