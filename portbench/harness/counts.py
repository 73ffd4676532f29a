"""The yardstick's arithmetic: the cards' published peaks, the model
FLOPs of a token from the configuration, and each crossbar call's
multiply-accumulates and bytes from its shapes."""

from __future__ import annotations

# dense rates without sparsity, from NVIDIA's data sheets
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops": 1.979e15, "bf16_flops": 0.989e15,
                              "hbm_bytes_s": 3.35e12},
}


def peaks(card: str) -> dict | None:
    return PEAKS.get(card)


def token_flops(c: dict, ctx: int) -> float:
    """Forward model FLOPs of one token that attends over ``ctx`` keys:
    every projection as 2 x in x out (the experts a token is routed to,
    the router), the attention scores and their weighted sum (2 x 2 x
    heads x head_dim x ctx a layer), and the output projection."""
    d, hd = c["hidden_size"], c["head_dim"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    proj = 2 * d * q + 2 * 2 * d * kv + 2 * q * d
    ff = c["intermediate_size"]
    if c.get("num_experts"):
        ffn = (2 * d * c["num_experts"]
               + c["num_experts_per_tok"] * 3 * 2 * d * ff)
    else:
        ffn = 3 * 2 * d * ff
    att = 2 * 2 * q * ctx
    return c["num_hidden_layers"] * (proj + ffn + att) + 2 * d * c[
        "vocab_size"]


def sequence_flops(c: dict, start: int, n: int) -> float:
    """Forward FLOPs of positions [start, start + n) of one causal
    sequence (position p attends over p + 1 keys)."""
    flat = token_flops(c, 0)
    per_key = token_flops(c, 1) - flat
    keys = n * start + n * (n + 1) // 2
    return n * flat + per_key * keys


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: forward and backward (3x the
    forward), no recompute."""
    return 3.0 * batch * sequence_flops(c, 0, seq)


def k2_call(x_shape, w_shape) -> tuple[float, float]:
    """(MACs, bytes) of one crossbar call: x [B, KB*M] f32, codes [KB, M,
    Np] int8, scales [KB, Np] f32, the DAC scale, out [B, Np] f32; each
    byte counted once."""
    b = x_shape[0]
    kb, m, np_ = w_shape[-3:]
    g = 1 if len(w_shape) == 3 else w_shape[0]
    macs = g * b * kb * m * np_
    nbytes = (b * kb * m * 4 + g * (kb * m * np_ + kb * np_ * 4)
              + 4 + g * b * np_ * 4)
    return float(macs), float(nbytes)


def expert_call(x_shape, w_shape) -> tuple[float, float]:
    """(MACs, bytes) of one expert-entry call: x [E, C, KB*M] f32, codes
    [E, KB, M, Np], scales [E, KB, Np], E DAC scales, out [E, C, Np]."""
    e, c, _ = x_shape
    _, kb, m, np_ = w_shape
    macs = e * c * kb * m * np_
    nbytes = (e * c * kb * m * 4 + e * (kb * m * np_ + kb * np_ * 4)
              + e * 4 + e * c * np_ * 4)
    return float(macs), float(nbytes)


def bound_s(macs: float, nbytes: float, pk: dict) -> float:
    """The least time of a call: its operations at the int8 peak or its
    bytes at the memory rate, whichever is longer."""
    return max(2.0 * macs / pk["int8_ops"], nbytes / pk["hbm_bytes_s"])
