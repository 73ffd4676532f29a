"""k2_roofline.train: the K2 calls of the traced training steps, the
sum of each call's bound (max of 2 x MACs at the int8 peak and its bytes
at the memory rate) over the device time of the kernels inside their
ranges, in percent. Read noise is in the time and not in the bound."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "k2", "pb.k2")
