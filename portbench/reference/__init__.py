"""The plain reference that decides `correct`: PyTorch operations only,
importing nothing of the port. `aimc` is the crossbar arithmetic,
`model` the transformer (dense and MoE) forward, its training step and
AdamW. `prng`, `cprng` and `f32math` are frozen copies of the port's
plain draws, so that both sides draw the same programming and read
noise from the same keys."""
