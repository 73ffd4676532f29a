"""expert_roofline.train: the rule of `k2_roofline.train` over the expert
entry's calls (`aimc_mvm_experts`) of the traced training steps."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "train", "experts", "pb.experts")
