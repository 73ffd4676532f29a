"""The benchmark of the PyTorch and CUDA port (`repro_torch`): cells,
configurations, traffic mixes and per-layer metrics as data, a harness
that drives the port's own entry points, and a plain reference that
decides whether a run's outputs are correct. See README.md."""
