"""Parity of the port's AIMClib (`repro_torch/core/aimclib.py`) with the JAX
reference's (`repro/core/aimclib.py`): the same mapping calls give the same
CM_* instruction counts, tile placements and program names, and the same
context key gives the same programming noise and read seeds.

Tolerances: counts, placements and names are exact; programmed codes are
exact here (no code of these draws sits on a rounding tie) and outputs
agree within 1e-5 * max(1, max|y|), the f32 association of the row-block
sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aimclib as jl
from repro.core.aimc import AimcConfig as JConfig
from repro.core.noise import NoiseModel as JNoise
from repro_torch.core import aimclib as tl
from repro_torch.core import prng
from repro_torch.core.aimc import AimcConfig as TConfig
from repro_torch.core.noise import NoiseModel as TNoise


def _w(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _fields(record):
    """A frozen dataclass (the two packages' own classes) as plain tuples."""
    return dataclasses.astuple(record)


def _contexts(noisy: bool, rows: int = 128):
    nm_j = JNoise(sigma_read=0.003) if noisy else JNoise(enabled=False)
    nm_t = TNoise(sigma_read=0.003) if noisy else TNoise(enabled=False)
    return (jl.AimcContext(JConfig(tile_rows=rows, noise=nm_j),
                           jax.random.PRNGKey(4)),
            tl.AimcContext(TConfig(tile_rows=rows, noise=nm_t),
                           prng.PRNGKey(4)))


def _map_all(ctx, to):
    ctx.map_matrix("fc", to(_w(0, (200, 96))))
    ctx.map_gates("cell", [to(_w(1 + g, (70, 40))) for g in range(4)])
    ctx.map_gate_stack("stack", [to(_w(5 + g, (130, 64))) for g in range(3)])


@pytest.mark.parametrize("noisy", [False, True])
def test_mapping_counts_placements_and_names_equal(noisy):
    cj, ct = _contexts(noisy)
    _map_all(cj, jnp.asarray)
    _map_all(ct, torch.from_numpy)
    pj, pt = cj.program(), ct.program()
    assert pt.names == pj.names == ("cell", "fc", "stack")
    assert _fields(ct.tile_map()) == _fields(cj.tile_map())
    assert _fields(ct.instruction_counts()) == _fields(cj.instruction_counts())
    for name in pj.names:
        np.testing.assert_array_equal(pt[name].w_q.numpy(),
                                      np.asarray(pj[name].w_q))
        np.testing.assert_array_equal(pt[name].s_w.numpy(),
                                      np.asarray(pj[name].s_w))


@pytest.mark.parametrize("noisy", [False, True])
def test_linear_paths_and_key_chain_match_reference(noisy):
    cj, ct = _contexts(noisy)
    _map_all(cj, jnp.asarray)
    _map_all(ct, torch.from_numpy)
    x = _w(9, (3, 200), 1.0)
    hx = _w(10, (3, 70), 1.0)
    sx = _w(11, (3, 130), 1.0)
    outs_j = [cj.linear("fc", jnp.asarray(x), activation="relu"),
              cj.linear("cell", jnp.asarray(hx)),
              cj.linear_stack("stack", jnp.asarray(sx),
                              activations=("sigmoid", "tanh", "none"))]
    outs_t = [ct.linear("fc", torch.from_numpy(x), activation="relu"),
              ct.linear("cell", torch.from_numpy(hx)),
              ct.linear_stack("stack", torch.from_numpy(sx),
                              activations=("sigmoid", "tanh", "none"))]
    cj.queue_vector("fc", jnp.asarray(x))
    cj.process("fc")
    outs_j.append(cj.dequeue_vector("fc"))
    ct.queue_vector("fc", torch.from_numpy(x))
    ct.process("fc")
    outs_t.append(ct.dequeue_vector("fc"))
    for y_t, y_j in zip(outs_t, outs_j):
        assert tuple(y_t.shape) == y_j.shape
        tol = 1e-5 * max(1.0, float(jnp.abs(y_j).max()))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                                   atol=tol)
    assert _fields(ct.instruction_counts()) == _fields(cj.instruction_counts())


def test_instruction_flow_order_errors():
    ctx = tl.AimcContext(TConfig(tile_rows=128))
    ctx.map_matrix("fc", torch.from_numpy(_w(0, (128, 32))))
    x = torch.from_numpy(_w(1, (4, 128), 1.0))
    with pytest.raises(RuntimeError):
        ctx.process("fc")                  # process before queue
    with pytest.raises(RuntimeError):
        ctx.dequeue_vector("fc")           # dequeue before queue
    ctx.queue_vector("fc", x)
    ctx.process("fc")
    assert tuple(ctx.dequeue_vector("fc").shape) == (4, 32)
    with pytest.raises(RuntimeError):
        ctx.dequeue_vector("fc")           # double dequeue
    with pytest.raises(KeyError):
        ctx.linear("nope", x)
    with pytest.raises(ValueError):
        ctx.map_matrix("fc", torch.zeros(8, 8))
    with pytest.raises(ValueError):
        ctx.map_gates("g", [torch.zeros(8, 4), torch.zeros(9, 4)])
    assert "fc" in ctx and "g" not in ctx


def test_digital_helpers():
    x = torch.tensor([[-1.0, 0.5, 2.0]])
    assert torch.equal(tl.relu(x), torch.tensor([[0.0, 0.5, 2.0]]))
    np.testing.assert_allclose(tl.softmax(x).sum().item(), 1.0, rtol=1e-6)
    scale = torch.tensor(2.0 / 127)
    q = tl.cast_to_int8(x, scale)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jl.cast_to_int8(jnp.asarray(x.numpy()),
                                              jnp.float32(2.0 / 127))))
    np.testing.assert_array_equal(tl.cast_from_int8(q, scale).numpy(),
                                  np.asarray(jl.cast_from_int8(
                                      jnp.asarray(q.numpy()),
                                      jnp.float32(2.0 / 127))))
