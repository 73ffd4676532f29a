"""ctypes wrappers of the Hopper AIMC MVM kernels (`csrc/aimc_mvm.cu`).

  * `aimc_mvm_v1`      — kernel K1, replaces `aimc_matmul_pallas`
    (`repro/kernels/aimc_mvm.py:118`): read noise from an explicit
    `[KB, B, Np]` operand, no epilogue.
  * `aimc_mvm_v2`      — kernel K2, replaces `aimc_matmul_pallas_v2`
    (`repro/kernels/aimc_mvm.py:228`): one programmed projection.
  * `aimc_mvm_stacked` — kernel K3, replaces `aimc_matmul_pallas_stacked`
    (`repro/kernels/aimc_mvm.py:349`): a `[G, ...]` gate stack sharing x.
  * K4, ``noise_source="hw"`` on K2/K3 — replaces the hardware-PRNG branch
    of `_in_kernel_noise` (`repro/kernels/aimc_mvm.py:160-170`) with
    Philox4x32-10 (`csrc/philox.cuh`).

The shared library is compiled with `nvcc` for `sm_90a` at first use, into
``build/`` beside this file (listed in `.gitignore`), named by a hash of its
sources so an edited kernel is rebuilt. Each wrapper checks its operands,
allocates the output and the launch's workspace (int8 DAC codes, and the
per-row-block scratch of a split grid) with `torch.empty`, launches on
PyTorch's current stream without synchronising, raises if a launch was
refused, and adds one to `LAUNCHES[name]` per wrapper call, whatever number
of CUDA kernels the call issues (the DAC pass, the tensor-core MVM and, on
a split grid, the row-block sum): a run can read the counts to prove its
path went through the kernels; K2/K3 calls that draw "hw" noise
(sigma > 0, K4) count under the `_hw` names.
Nothing here falls back to the plain version (`kernels/ref.py`);
`kernels/ops.py` chooses by the device of the input.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from repro_torch.kernels.ref import NOISE_SOURCES

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_SOURCES = ("aimc_mvm.cu", "cprng.cuh", "philox.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_ACT_CODES = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
MAX_GATES = 16

# kernel name -> launches since the last `reset_counts()`
LAUNCHES = {"aimc_mvm_v1": 0, "aimc_mvm_v2": 0, "aimc_mvm_stacked": 0,
            "aimc_mvm_v2_hw": 0, "aimc_mvm_stacked_hw": 0}

_lock = threading.Lock()
_lib = None
BUILD_LOG: dict = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the AIMC kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libaimc_mvm_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernel library if this source hash has no build yet.
    Returns its path; the compiler's report lands in `BUILD_LOG`."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / "aimc_mvm.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: concurrent builders agree
    BUILD_LOG.update(cmd=" ".join(cmd), report=proc.stderr + proc.stdout)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.aimc_mvm_launch
            fn.argtypes = ([ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_float, ctypes.c_uint,
                              ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.aimc_mvm_plan.argtypes = (
                [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)])
            lib.aimc_mvm_plan.restype = ctypes.c_int
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=1024)
def _plan(device_index: int, b: int, kb: int, m: int, np_: int,
          g: int) -> tuple[int, int]:
    """(plan code, workspace bytes) of the launcher for this shape; the plan
    depends on the device's SM count."""
    work = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        code = _load().aimc_mvm_plan(b, kb, m, np_, g, ctypes.byref(work))
    return int(code), int(work.value)


def launch_plan(device, b: int, kb: int, m: int, np_: int, g: int = 1):
    """The launcher's choice for a call of this shape on ``device``: rows
    per block (16 or 64), whether the grid splits over row blocks, the CUDA
    kernels the call issues (DAC pass, MVM, and the row-block sum when
    split) and the workspace bytes."""
    code, work = _plan(torch.device(device).index or 0, b, kb, m, np_, g)
    split = bool(code & 256)
    return {"rows_per_block": code & 255, "split": split,
            "kernels_per_call": 3 if split else 2, "workspace_bytes": work}


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")


def _launch(name, x, w_q, s_w, s_x, seed, bias, adc_step, sigma, acts,
            stacked, noise_source="counter", noise=None):
    """w_q [G, KB, M, Np], s_w [G, KB, Np], bias [G, Np] or None, noise
    [KB, B, Np] or None (K1)."""
    if not x.is_cuda:
        raise ValueError(f"{name} launches on a CUDA tensor; x is on "
                         f"{x.device}")
    g, kb, m, np_ = w_q.shape
    b = x.shape[0]
    _check(x, "x", torch.float32, x.device, 2)
    _check(w_q, "w_q", torch.int8, x.device, 4)
    _check(s_w, "s_w", torch.float32, x.device, 3)
    if x.shape[1] != kb * m:
        raise ValueError(f"x K={x.shape[1]} != KB*M={kb * m}")
    if tuple(s_w.shape) != (g, kb, np_):
        raise ValueError(f"s_w {tuple(s_w.shape)} != {(g, kb, np_)}")
    if np_ % 128:
        raise ValueError(f"Np={np_} is not 128-aligned (program_linear pads)")
    if not 1 <= g <= MAX_GATES:
        raise ValueError(f"G={g} outside 1..{MAX_GATES}")
    if s_x.numel() != 1 or s_x.dtype != torch.float32 or s_x.device != x.device:
        raise ValueError("s_x must be one f32 value on x's device")
    if sigma > 0.0 and seed is None:
        raise ValueError("sigma > 0 requires a seed")
    if noise_source not in NOISE_SOURCES:
        raise ValueError(f"unknown noise_source {noise_source!r}")
    if noise is not None:
        _check(noise, "read_noise", torch.float32, x.device, 3)
        if tuple(noise.shape) != (kb, b, np_):
            raise ValueError(f"read_noise {tuple(noise.shape)} != "
                             f"{(kb, b, np_)}")
    if bias is not None:
        _check(bias, "bias", torch.float32, x.device, 2)
        if tuple(bias.shape) != (g, np_):
            raise ValueError(f"bias {tuple(bias.shape)} != {(g, np_)}")
    packed = 0
    for i, a in enumerate(acts):
        packed |= _ACT_CODES[a] << (2 * i)
    out = torch.empty((g, b, np_), dtype=torch.float32, device=x.device)
    s_x = s_x.reshape(1)
    lib = _load()
    work = torch.empty(_plan(x.device.index or 0, b, kb, m, np_, g)[1],
                       dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.aimc_mvm_launch(
            x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            noise.data_ptr() if noise is not None else None, out.data_ptr(),
            b, kb, m, np_, g, float(adc_step), float(sigma),
            int(seed or 0) & 0xFFFFFFFF, int(stacked), packed,
            int(noise_source == "hw"), stream, work.data_ptr())
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name + ("_hw" if noise_source == "hw" and sigma > 0.0
                     else "")] += 1
    return out


def aimc_mvm_v1(x, w_q, s_w, s_x, read_noise, *, adc_step: float):
    """K1: x f32 [B, KB*M], w_q int8 [KB, M, Np], s_w [KB, Np], s_x one f32
    device value, read_noise f32 [KB, B, Np] in accumulator LSBs -> f32
    [B, Np]; no epilogue."""
    y = _launch("aimc_mvm_v1", x, w_q.unsqueeze(0), s_w.unsqueeze(0), s_x,
                None, None, adc_step, 0.0, ("none",), stacked=False,
                noise=read_noise)
    return y[0]


def aimc_mvm_v2(x, w_q, s_w, s_x, seed=None, bias=None, *, adc_step: float,
                sigma: float = 0.0, activation: str = "none",
                noise_source: str = "counter"):
    """K2: x f32 [B, KB*M], w_q int8 [KB, M, Np], s_w [KB, Np], s_x one f32
    device value, bias [Np] or None -> f32 [B, Np], epilogue applied; K4
    when ``noise_source="hw"``."""
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown epilogue {activation!r}")
    np_ = w_q.shape[-1]
    y = _launch("aimc_mvm_v2", x, w_q.unsqueeze(0), s_w.unsqueeze(0), s_x,
                seed, None if bias is None else bias.reshape(1, np_),
                adc_step, sigma, (activation,), stacked=False,
                noise_source=noise_source)
    return y[0]


def aimc_mvm_stacked(x, w_q, s_w, s_x, seed=None, bias=None, *,
                     adc_step: float, sigma: float = 0.0,
                     activations="none", noise_source: str = "counter"):
    """K3: w_q int8 [G, KB, M, Np], s_w [G, KB, Np], bias [G, Np] or None ->
    f32 [G, B, Np]; gate g draws noise under `cprng.stack_seed(seed, g)`
    (counter or, K4, Philox)."""
    g = w_q.shape[0]
    if isinstance(activations, str):
        activations = (activations,) * g
    if len(activations) != g:
        raise ValueError(f"{len(activations)} activations for G={g} gates")
    for a in activations:
        if a not in _ACT_CODES:
            raise ValueError(f"unknown epilogue {a!r}")
    return _launch("aimc_mvm_stacked", x, w_q, s_w, s_x, seed, bias,
                   adc_step, sigma, tuple(activations), stacked=True,
                   noise_source=noise_source)
