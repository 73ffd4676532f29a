"""k2_roofline.serve: `k2_roofline.train`'s rule over the K2 calls of the
traced serving window."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "serve", "k2", "pb.k2")
