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
  * `aimc_mvm_experts` — K2 over an `[E, ...]` expert stack, each expert
    on its own input, DAC scale and read seed: the counterpart of
    `jax.vmap` over `aimc_matmul_pallas_v2` in the MoE FFN
    (`repro/models/moe.py:74-86`), one launch for all E experts. Two
    bodies, the same bits: `csrc/aimc_mvm.cu`'s ("mma", small capacities)
    and `csrc/aimc_experts.cuh`'s ("wide", C >= 32 rows per expert with
    a tile for every SM: wgmma fed by TMA, warp-specialised, its
    noise draws overlapping the MACs); `expert_body` chooses from the shape
    and the SM count and `launch_plan(..., experts=True)` reports the
    choice. The wide body's branch-free epilogue is taken only at an ADC
    step where `check_fast_paths` passed on the card (`fast_epilogue`).
  * `draws` — the draw functions alone (``aimc_draws``: the counter draw,
    Box-Muller's radius and cosine, `f32math.log1p`), held to their plain
    versions (`ref.draws_ref`) bit for bit; it replaces no TPU kernel.

The shared library (`csrc/aimc_mvm.cu` and `csrc/aimc_experts.cu`, one
`nvcc -c` each, started together, then linked) is compiled for `sm_90a` at
first use, into ``build/`` beside this file (listed in `.gitignore`), named
by a hash of its sources so an edited kernel is rebuilt. Each wrapper
checks its operands, allocates the output and the launch's workspace (int8
DAC codes, and the per-row-block scratch of a split grid) with
`torch.empty`, launches on PyTorch's current stream without synchronising,
raises if a launch was refused, and adds one to `LAUNCHES[name]` per
wrapper call, whatever number
of CUDA kernels the call issues (the DAC pass, the tensor-core MVM and, on
a split grid, the row-block sum): a run can read the counts to prove its
path went through the kernels; K2/K3 calls that draw "hw" noise
(sigma > 0, K4) count under the `_hw` names.
The programmed operands may be column views of a wider state (a
`core.aimc.ColumnPiece`): the kernels read them at the whole's row stride
and draw the whole's noise for their columns (``col0``, ``nc``).
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

from repro_torch.kernels import ref
from repro_torch.kernels.ref import NOISE_SOURCES

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_UNITS = ("aimc_mvm.cu", "aimc_experts.cu")   # one nvcc each, in parallel
_SOURCES = (*_UNITS, "aimc_experts.cuh", "cprng.cuh", "f32math.cuh",
            "philox.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_ACT_CODES = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}
MAX_GATES = 16

# kernel name -> launches since the last `reset_counts()`
LAUNCHES = {"aimc_mvm_v1": 0, "aimc_mvm_v2": 0, "aimc_mvm_stacked": 0,
            "aimc_mvm_v2_hw": 0, "aimc_mvm_stacked_hw": 0,
            "aimc_mvm_experts": 0}

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
    """Compile the kernel library if this source hash has no build yet:
    one ``nvcc -c`` per translation unit, all started together, then one
    link. Returns its path; the compiler's report lands in `BUILD_LOG`
    (and beside the library, for a later process that finds it built)."""
    out = library_path()
    report_path = out.with_suffix(".txt")
    if out.exists():
        if not BUILD_LOG and report_path.exists():
            BUILD_LOG.update(cmd="(built earlier)",
                             report=report_path.read_text())
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_BUILD))
    try:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[_nvcc(), *compile_flags, "-c", "-o",
                 str(tmp / f"{Path(unit).stem}.o"), str(_CSRC / unit)]
                for unit in _UNITS]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outs = [proc.communicate() for proc in procs]
        report = "".join(err + so for so, err in outs)
        for proc, (so, err) in zip(procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{so}\n{err}")
        link = [_nvcc(), "-shared", "-o", str(tmp / "lib.so"),
                *(c[c.index("-o") + 1] for c in cmds)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        (tmp / "report.txt").write_text(report)
        os.replace(tmp / "report.txt", report_path)
        os.replace(tmp / "lib.so", out)   # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_LOG.update(cmd="\n".join(" ".join(c) for c in [*cmds, link]),
                     report=report)
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
                              ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 3)
            fn.restype = ctypes.c_int
            ex = lib.aimc_mvm_experts_launch
            ex.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 5)
            ex.restype = ctypes.c_int
            lib.aimc_mvm_plan.argtypes = (
                [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)])
            lib.aimc_mvm_experts_plan.argtypes = (
                [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)])
            for plan in (lib.aimc_mvm_plan, lib.aimc_mvm_experts_plan):
                plan.restype = ctypes.c_int
            lib.aimc_experts_check.argtypes = [
                ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
            lib.aimc_experts_check.restype = ctypes.c_int
            lib.aimc_draws.argtypes = [
                ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
            lib.aimc_draws.restype = ctypes.c_int
            _lib = lib
    return _lib


# the expert entry's bodies: aimc_mvm.cu's (small capacities, any grid)
# and aimc_experts.cuh's (tiles of WIDE_ROWS rows x 128 columns, one
# persistent block per SM)
EXPERT_BODIES = ("mma", "wide")
WIDE_ROWS = 128


def expert_body(b: int, kb: int, m: int, np_: int, e: int,
                sms: int) -> str:
    """The body the expert entry runs for ``e`` experts of ``b`` rows each
    on x [E, B, KB*M] and a panel ``np_`` columns wide, on a card with
    ``sms`` SMs: "wide" (`csrc/aimc_experts.cuh`) once an expert fills a
    quarter of a 128-row tile (B >= 32) and the tiles cover every SM, else
    "mma" (`csrc/aimc_mvm.cu`'s expert body: decode, prefill and the
    health probes, 1-2 rows per expert). The line is where the bodies'
    times cross on an H100 (`tools/expert_profile.py`'s sweep): under 32
    rows the wide body spends a 128-row tile's MACs and draws on fewer
    rows, and with fewer tiles than SMs its draws run on fewer warps than
    the small body's. Both give the same bits."""
    tiles = (np_ // 128) * -(-b // WIDE_ROWS) * e
    return "wide" if b >= WIDE_ROWS // 4 and tiles >= sms else "mma"


def plan_for(b: int, kb: int, m: int, np_: int, g: int, sms: int,
             experts: bool = False) -> tuple[int, int, str]:
    """`_plan`'s (plan code, workspace bytes, body) reckoned in Python for
    a card with ``sms`` SMs, without the library (`csrc/aimc_mvm.cu`'s
    ``make_plan`` / ``plan_code`` and `csrc/aimc_experts.cu`'s
    ``aimc_experts_wide_plan``): the step counter's kernels on ``meta``
    allocate this workspace."""
    body = expert_body(b, kb, m, np_, g, sms) if experts else "mma"
    if b <= 0 or kb < 1 or m < 1 or g < 1:
        return 0, 0, body
    mp = -(-m // 128) * 128
    if body == "wide":
        return WIDE_ROWS, -(-(g * b * kb * mp) // 256) * 256, body
    cols = (np_ // 128) * g
    bm = 64 if b > 16 and -(-b // 64) * cols >= sms else 16
    split = kb > 1 and -(-b // bm) * cols < 2 * sms and 8 * b <= m
    rows = b * (g if experts else 1)
    work = -(-(rows * kb * mp) // 256) * 256
    if split:
        work += g * kb * b * np_ * 4
    return bm | (256 if split else 0), work, body


def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(device_index: int, b: int, kb: int, m: int, np_: int,
          g: int, experts: bool = False) -> tuple[int, int, str]:
    """(plan code, workspace bytes, body) of the launcher for this shape;
    the plan depends on the device's SM count. It depends on a column
    piece's own width ``np_`` alone, not on the row stride it is read
    at."""
    work = ctypes.c_longlong(0)
    lib = _load()
    body = (expert_body(b, kb, m, np_, g, _sms(device_index)) if experts
            else "mma")
    with torch.cuda.device(device_index):
        if experts:
            code = lib.aimc_mvm_experts_plan(b, kb, m, np_, g,
                                             EXPERT_BODIES.index(body),
                                             ctypes.byref(work))
        else:
            code = lib.aimc_mvm_plan(b, kb, m, np_, g, ctypes.byref(work))
    return int(code), int(work.value), body


def launch_plan(device, b: int, kb: int, m: int, np_: int, g: int = 1,
                experts: bool = False):
    """The launcher's choice for a call of this shape on ``device``: rows
    per block (16 or 64; the wide expert body's 128 per tile), whether the
    grid splits over row blocks, the CUDA kernels the call issues (DAC
    pass, MVM, and the row-block sum when split), the workspace bytes and
    the body. ``experts``: the expert entry, with ``g`` experts of ``b``
    rows each, whose body is `expert_body`'s choice."""
    code, work, body = _plan(torch.device(device).index or 0, b, kb, m,
                             np_, g, experts)
    split = bool(code & 256)
    return {"rows_per_block": code & 255, "split": split,
            "kernels_per_call": 3 if split else 2, "workspace_bytes": work,
            "body": body}


def check_fast_paths(device, adc_step: float) -> dict:
    """The wide expert body's branch-free epilogue (`csrc/aimc_experts.cuh`)
    against the library calls it stands for, on ``device``: mismatches of
    its Box-Muller radius against `csrc/cprng.cuh`'s (sqrtf of f32math's
    log) over all 2^24 words, of its division against IEEE
    ``a / adc_step`` over every float |a| <= 2^25 (every sum a launch that
    takes it can give), of its draw against the counter draw on 2^24
    counters, and the least nonzero |cos| of a draw. Every count is 0 where
    the body's bits equal the library calls' at this step."""
    dev = torch.device(device)
    bad = torch.zeros(4, dtype=torch.int64, device=dev)
    bad[3] = 0x7F800000
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.aimc_experts_check(
            float(adc_step), bad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"aimc_experts_check failed: CUDA error {err}")
    v = bad.tolist()
    return {"radius_mismatches": v[0], "div_mismatches": v[1],
            "draw_mismatches": v[2],
            "min_abs_cos": float(torch.tensor([v[3]], dtype=torch.int32)
                                 .view(torch.float32))}


def draws(what: str, *, n: int = 1 << 24, i0: int = 0, seed: int = 0,
          x: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """The kernels' draw functions alone, computed by the library's
    ``aimc_draws`` on a CUDA ``device`` (``x``'s for log1p): f32 [n] of
    ``ref.draws_ref`` (`csrc/cprng.cuh`, `csrc/f32math.cuh`), which holds
    them to their plain versions bit for bit. It replaces no TPU kernel and
    counts no launch."""
    if what == "log1p":
        x = ref.check_draws(what, n, i0, x)
        dev, n = x.device, x.numel()
    else:
        ref.check_draws(what, n, i0, x)
        dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the draws kernel runs on a CUDA device, not "
                         f"{dev}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.aimc_draws(ref.DRAWS.index(what), int(seed) & 0xFFFFFFFF,
                             int(i0), x.data_ptr() if x is not None else None,
                             out.data_ptr(), n,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"aimc_draws failed: CUDA error {err}")
    return out


@functools.lru_cache(maxsize=64)
def fast_epilogue(device_index: int, adc_step: float) -> bool:
    """Whether the wide body may take its branch-free epilogue at
    ``adc_step`` on this card: `check_fast_paths` found no mismatch (run
    once per card and step, synchronously; a few ms). Otherwise the body
    runs the library calls, which give the same bits more slowly."""
    got = check_fast_paths(torch.device("cuda", device_index), adc_step)
    return got["min_abs_cos"] > 0.0 and not any(
        v for k, v in got.items() if k != "min_abs_cos")


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


def _check_cols(w_q, s_w, device):
    """Check a programmed operand pair w_q [G, KB, M, Np] / s_w [G, KB, Np]
    that may be a column view of a wider state (each row read at one
    stride, the columns contiguous); returns that row stride ``ld`` (Np
    for a contiguous state)."""
    for t, name, dtype in ((w_q, "w_q", torch.int8),
                           (s_w, "s_w", torch.float32)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if w_q.dim() != 4 or s_w.dim() != 3:
        raise ValueError(f"w_q must be 4-D and s_w 3-D, got "
                         f"{tuple(w_q.shape)} and {tuple(s_w.shape)}")
    g, kb, m, np_ = w_q.shape
    ld = w_q.stride(2) if m > 1 else np_
    want_w = (kb * m * ld, m * ld, ld, 1)
    want_s = (kb * ld, ld, 1)
    for t, name, want in ((w_q, "w_q", want_w), (s_w, "s_w", want_s)):
        if any(n > 1 and st != w for n, st, w in zip(t.shape, t.stride(),
                                                    want)):
            raise ValueError(f"{name} strides {t.stride()} are not a column "
                             f"view at row stride {ld}")
    if ld % 128 or w_q.data_ptr() % 16 or s_w.data_ptr() % 16:
        raise ValueError(f"w_q/s_w must start on a 128-column boundary of "
                         f"a 128-aligned state (row stride {ld})")
    return ld


def _cols(col0: int, nc, np_: int, ld: int) -> tuple[int, int]:
    """(col0, nc) of a launch over columns [col0, col0 + Np) of a state nc
    columns wide (default: the whole, ``ld`` wide)."""
    nc = ld if nc is None else int(nc)
    if col0 % 128 or nc % 128 or col0 < 0 or col0 + np_ > nc:
        raise ValueError(f"columns [{col0}, {col0 + np_}) outside a "
                         f"128-aligned state of {nc} columns")
    return int(col0), nc


def _launch(name, x, w_q, s_w, s_x, seed, bias, adc_step, sigma, acts,
            stacked, noise_source="counter", noise=None, col0=0, nc=None):
    """w_q [G, KB, M, Np], s_w [G, KB, Np] (column views of a state ``nc``
    wide starting at ``col0`` allowed), bias [G, Np] or None, noise
    [KB, B, Np] or None (K1)."""
    if not x.is_cuda:
        raise ValueError(f"{name} launches on a CUDA tensor; x is on "
                         f"{x.device}")
    g, kb, m, np_ = w_q.shape
    b = x.shape[0]
    _check(x, "x", torch.float32, x.device, 2)
    ld = _check_cols(w_q, s_w, x.device)
    col0, nc = _cols(col0, nc, np_, ld)
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
            int(noise_source == "hw"), stream, work.data_ptr(), ld, col0, nc)
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
                noise_source: str = "counter", col0: int = 0, nc=None):
    """K2: x f32 [B, KB*M], w_q int8 [KB, M, Np], s_w [KB, Np], s_x one f32
    device value, bias [Np] or None -> f32 [B, Np], epilogue applied; K4
    when ``noise_source="hw"``. ``w_q``/``s_w`` may be a column view
    ``[..., col0:col0 + Np]`` of a state ``nc`` columns wide: the launch
    reads them at the whole's row stride and draws the whole's noise for
    its columns."""
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown epilogue {activation!r}")
    np_ = w_q.shape[-1]
    y = _launch("aimc_mvm_v2", x, w_q.unsqueeze(0), s_w.unsqueeze(0), s_x,
                seed, None if bias is None else bias.reshape(1, np_),
                adc_step, sigma, (activation,), stacked=False,
                noise_source=noise_source, col0=col0, nc=nc)
    return y[0]


def aimc_mvm_stacked(x, w_q, s_w, s_x, seed=None, bias=None, *,
                     adc_step: float, sigma: float = 0.0,
                     activations="none", noise_source: str = "counter",
                     col0: int = 0, nc=None):
    """K3: w_q int8 [G, KB, M, Np], s_w [G, KB, Np], bias [G, Np] or None ->
    f32 [G, B, Np]; gate g draws noise under `cprng.stack_seed(seed, g)`
    (counter or, K4, Philox); column views as for `aimc_mvm_v2`."""
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
                   noise_source=noise_source, col0=col0, nc=nc)


def _device_seeds(seeds, e: int, device) -> torch.Tensor:
    """E uint32 read seeds (host ints) as an int32 [E] tensor on ``device``:
    one non-blocking copy from pinned memory (PyTorch's host allocator keeps
    the pinned buffer alive until the copy has run)."""
    if len(seeds) != e:
        raise ValueError(f"{len(seeds)} read seeds for E={e} experts")
    words = [int(s) & 0xFFFFFFFF for s in seeds]
    host = torch.tensor([w - (1 << 32) if w >= 1 << 31 else w
                         for w in words], dtype=torch.int32).pin_memory()
    return host.to(device, non_blocking=True)


def aimc_mvm_experts(x, w_q, s_w, s_x, seeds=None, *, adc_step: float,
                     sigma: float = 0.0, col0: int = 0, nc=None):
    """K2 over an expert stack in one launch: x f32 [E, B, KB*M], w_q int8
    [E, KB, M, Np], s_w f32 [E, KB, Np], s_x f32 [E] (each expert's own DAC
    scale, on the device), ``seeds`` E uint32 read seeds (host ints; needed
    when ``sigma > 0``) -> f32 [E, B, Np], no epilogue. Expert e equals
    `aimc_mvm_v2(x[e], w_q[e], s_w[e], s_x[e], seeds[e], sigma=sigma)` bit
    for bit: counter read noise over its own B rows. Column views as for
    `aimc_mvm_v2`."""
    if sigma > 0.0 and seeds is None:
        raise ValueError("sigma > 0 requires a read seed per expert")
    if not x.is_cuda:
        raise ValueError(f"aimc_mvm_experts launches on a CUDA tensor; x is "
                         f"on {x.device}")
    e, kb, m, np_ = w_q.shape
    _check(x, "x", torch.float32, x.device, 3)
    ld = _check_cols(w_q, s_w, x.device)
    col0, nc = _cols(col0, nc, np_, ld)
    _check(s_x, "s_x", torch.float32, x.device, 1)
    b = x.shape[1]
    if x.shape[0] != e or x.shape[2] != kb * m:
        raise ValueError(f"x {tuple(x.shape)} != {(e, b, kb * m)}")
    if tuple(s_w.shape) != (e, kb, np_):
        raise ValueError(f"s_w {tuple(s_w.shape)} != {(e, kb, np_)}")
    if tuple(s_x.shape) != (e,):
        raise ValueError(f"s_x {tuple(s_x.shape)} != {(e,)}")
    if np_ % 128:
        raise ValueError(f"Np={np_} is not 128-aligned (program_linear pads)")
    dev_seeds = _device_seeds(seeds, e, x.device) if sigma > 0.0 else None
    out = torch.empty((e, b, np_), dtype=torch.float32, device=x.device)
    lib = _load()
    _, need, body = _plan(x.device.index or 0, b, kb, m, np_, e, True)
    work = torch.empty(need, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.aimc_mvm_experts_launch(
            x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
            dev_seeds.data_ptr() if dev_seeds is not None else None,
            out.data_ptr(), b, kb, m, np_, e, float(adc_step), float(sigma),
            stream, work.data_ptr(), ld, col0, nc,
            EXPERT_BODIES.index(body),
            int(body == "wide" and fast_epilogue(x.device.index or 0,
                                                 float(adc_step))))
    if err:
        raise RuntimeError(f"aimc_mvm_experts launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["aimc_mvm_experts"] += 1
    return out
