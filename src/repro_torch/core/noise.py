"""PCM non-ideality models (paper §III-C); PyTorch port of
`repro/core/noise.py`.

  * programming noise — write error at CM_INITIALIZE, Gaussian in int8-code
    units with a level-dependent sigma;
  * read noise        — additive bit-line Gaussian per CM_PROCESS, drawn
    inside the kernel from a scalar seed (`read_sigma_lsb`,
    `derive_read_seed`);
  * conductance drift — G(t) = G(t0) * (t/t0)^(-nu), with optional digital
    compensation.

Random draws take the reference's JAX PRNG keys (`core/prng.py`): the
same key gives the same bits as `jax.random`, and Gaussians within a few
ulps of it. Serving runs with `DISABLED`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.quant import QMAX


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """PCM non-ideality parameters (defaults from the PCM literature)."""

    enabled: bool = True
    sigma_prog_min: float = 0.010
    sigma_prog_max: float = 0.025
    sigma_read: float = 0.005
    drift_nu: float = 0.05
    drift_t_ratio: float = 1.0
    drift_compensate: bool = True
    drift_t0: float = 1.0
    drift_core_spread: float = 0.0

    def drift_gain(self) -> float:
        if self.drift_t_ratio <= 1.0:
            return 1.0
        return float(self.drift_t_ratio ** (-self.drift_nu))

    def compensation_gain(self) -> float:
        return 1.0 / self.drift_gain() if self.drift_compensate else 1.0

    def compensation_gain_at(self, t_since_program: float,
                             nu: float | None = None) -> float:
        """Digital dequant correction for a program of age
        ``t_since_program``: the inverse of the nominal power law."""
        if not (self.enabled and self.drift_compensate):
            return 1.0
        g = self.drift_gain_at(t_since_program, nu)
        return 1.0 / g if g > 0.0 else 1.0

    def drift_gain_at(self, t_since_program: float,
                      nu: float | None = None) -> float:
        """G(t)/G(t0) for a program of age ``t_since_program`` seconds."""
        if not self.enabled:
            return 1.0
        nu = self.drift_nu if nu is None else nu
        ratio = t_since_program / self.drift_t0
        if ratio <= 1.0 or nu == 0.0:
            return 1.0
        return float(ratio ** (-nu))

    def per_core_nu(self, core: int, seed: int = 0) -> float:
        """Deterministic per-core drift exponent nu * (1 + spread * u)."""
        if self.drift_core_spread == 0.0:
            return self.drift_nu
        u = 2.0 * unit_hash(seed, core) - 1.0
        return self.drift_nu * (1.0 + self.drift_core_spread * u)


DISABLED = NoiseModel(enabled=False)


def drift_only(nu: float = 0.05, t0: float = 1.0, core_spread: float = 0.0,
               compensate: bool = False) -> NoiseModel:
    """A NoiseModel that drifts with program age but is otherwise ideal."""
    return NoiseModel(enabled=True, sigma_prog_min=0.0, sigma_prog_max=0.0,
                      sigma_read=0.0, drift_nu=nu, drift_t_ratio=1.0,
                      drift_compensate=compensate, drift_t0=t0,
                      drift_core_spread=core_spread)


_MASK64 = (1 << 64) - 1


def unit_hash(*ints: int) -> float:
    """Deterministic hash of integers to [0, 1) (splitmix64 finalizer)."""
    h = 0x9E3779B97F4A7C15
    for v in ints:
        h = (h ^ (int(v) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h = h ^ (h >> 31)
    return h / float(1 << 64)


def programming_noise(key: torch.Tensor, w_codes: torch.Tensor,
                      nm: NoiseModel) -> torch.Tensor:
    """Additive write error on conductance codes (float; caller rounds),
    drawn on ``w_codes``' device from ``key``."""
    if not nm.enabled:
        return torch.zeros_like(w_codes, dtype=torch.float32)
    level = w_codes.to(torch.float32).abs() / QMAX
    sigma = (nm.sigma_prog_min
             + (nm.sigma_prog_max - nm.sigma_prog_min) * level) * QMAX
    return sigma * prng.normal(key, w_codes.shape, device=w_codes.device)


def read_noise(key: torch.Tensor, shape, active_rows: int, nm: NoiseModel,
               device=None) -> torch.Tensor:
    """Additive bit-line noise in accumulator LSBs for one CM_PROCESS, as a
    bulk tensor: the operand of the v1 kernel K1 (`ops.aimc_matmul`). The
    execution path draws its noise inside kernel K2/K3 from a scalar seed."""
    if not nm.enabled or nm.sigma_read == 0.0:
        return torch.zeros(shape, dtype=torch.float32,
                           device=key.device if device is None else device)
    sigma = read_sigma_lsb(active_rows, nm)
    return sigma * prng.normal(key, shape, device=device)


def read_sigma_lsb(active_rows: int, nm: NoiseModel) -> float:
    """Read-noise std in accumulator LSBs for an ``active_rows``-row tile
    (0.0 turns the kernel's noise branch off)."""
    if not nm.enabled:
        return 0.0
    return float(nm.sigma_read * QMAX * (active_rows ** 0.5))


def derive_read_seed(key: torch.Tensor) -> int:
    """`jax.random.bits(key, uint32)`: the scalar seed the kernel expands
    per element. A host int, so passing it to a launch costs no device
    sync (the key's words are read on the host)."""
    k0, k1 = prng.key_words(key)
    y0, y1 = prng.threefry2x32(k0, k1, 0, 0)
    return y0 ^ y1
