"""Cells at a size a CPU test run can hold: the port's smoke widths of
the benchmark's two architectures, with the benchmark's own traffic
shapes scaled down."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness.spec import Cell  # noqa: E402

NOISE = {"sigma_read": 0.003, "sigma_prog_min": 0.010,
         "sigma_prog_max": 0.025}


def train_cell(noise: bool = True) -> Cell:
    cfg = {"name": "olmoe-tiny", "num_hidden_layers": 2, "hidden_size": 48,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "head_dim": 12, "intermediate_size": 32, "num_experts": 8,
           "num_experts_per_tok": 2, "vocab_size": 128, "rope_theta": 1e4,
           "run": {"port_arch": "olmoe-1b-7b", "port_cfg": "smoke",
                   "param_dtype": "bfloat16", "compute_dtype": "bfloat16",
                   "microbatch": 2, "optimizer": "adamw",
                   "capacity_factor": 1.25, "rms_norm_eps": 1e-6,
                   "tile_rows": 64, "tile_cols": 64, "adc_alpha": 1.0,
                   "input_scale": 0.0}}
    traffic = {"kind": "train", "global_batch": 4, "seq_len": 32,
               "check_steps": 3, "trace_steps": 1,
               "noise": NOISE if noise else None}
    # at this size the losses of later steps and the change after three
    # steps read alike for the program and the control (Adam's first steps
    # are signs of gradients near zero): only the first gradient and the
    # change separate a sound run from the control and the faults here
    # digital_gap: sound runs read 0.0018 here (bf16 outputs), the e4m3
    # control 0.046-0.049
    limits = {"limits": {"grad_gap": 0.01, "step_gap": 0.1,
                         "digital_gap": 0.012}}
    return Cell("olmoe-tiny.train", 1, cfg, traffic, limits)


def serve_cell() -> Cell:
    cfg = {"name": "granite-tiny", "num_hidden_layers": 2, "hidden_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "intermediate_size": 160, "vocab_size": 128,
           "rope_theta": 1e4,
           "run": {"port_arch": "granite-8b", "port_cfg": "smoke",
                   "param_dtype": "float32", "compute_dtype": "float32",
                   "rms_norm_eps": 1e-6, "tile_rows": 512, "tile_cols": 512,
                   "adc_alpha": 1.0, "input_scale": 0.05}}
    traffic = {"kind": "serve", "slots": 4, "backlog": 64,
               "prompt": {"block": 8, "median": 12, "sigma": 0.6, "min": 4,
                          "max": 24},
               "output": {"min": 4, "max": 8}, "max_seq": 32,
               "page_size": 4, "prefill_chunk": 8, "decode_chunk": 1,
               "check_tokens": 24, "trace_seconds": 0.5}
    # digital_gap: sound runs read 1.5e-7 here (f32), TF32 products 3.2e-4
    return Cell("granite-tiny.serve", 1, cfg, traffic,
                {"limits": {"token_gap": 0.01, "digital_gap": 1e-5}})
