"""idle_share.train: the share of the traced training window in which no
kernel, copy or set ran on the card, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.idle(ctx, "train")
