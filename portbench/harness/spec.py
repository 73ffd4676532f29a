"""A cell as data: its configuration file (the published sizes and how
the port runs them), its traffic file and its limits file, read by name;
the port's arch spec and execution built from them, and the reference's
model and crossbar from the same numbers."""

from __future__ import annotations

import dataclasses

from portbench.harness import common
from portbench.reference import aimc as ref_aimc
from portbench.reference import model as ref_model


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict

    @property
    def run(self) -> dict:
        return self.config["run"]

    @property
    def noise(self) -> dict | None:
        return self.traffic.get("noise")


def load(workload: str) -> Cell:
    bench = common.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise common.Unfit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next((c for c in bench["configs"] if c["name"] == w["config"]),
               None)
    if cfg is None:
        raise common.Unfit(f"no config {w['config']!r} in BENCHMARK.json")
    return Cell(workload, int(w["chips"]),
                common.data_file("configs", w["config"]),
                common.data_file("traffic", w["traffic"]),
                common.data_file("limits", workload))


def ref_model_of(config: dict) -> ref_model.Model:
    c, r = config, config["run"]
    return ref_model.Model(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(r["rms_norm_eps"]),
        n_experts=c.get("num_experts", 0),
        top_k=c.get("num_experts_per_tok", 0),
        capacity_factor=float(r.get("capacity_factor", 1.25)))


def crossbar_of(config: dict, noise: dict | None,
                qmax: int = ref_aimc.QMAX) -> ref_aimc.Crossbar:
    """The reference's crossbar; ``qmax`` 7 is the int4 control."""
    r = config["run"]
    kw = {"qmax": qmax}
    if noise:
        kw.update(noise=True, sigma_read=noise["sigma_read"],
                  sigma_prog_min=noise["sigma_prog_min"],
                  sigma_prog_max=noise["sigma_prog_max"])
    xb = ref_aimc.Crossbar(tile_rows=r["tile_rows"],
                           adc_alpha=r["adc_alpha"],
                           input_scale=r["input_scale"], **kw)
    ref_aimc.sigma_check(xb)
    return xb


def port_spec(config: dict):
    """The port's `ArchSpec` for this configuration: its registered arch,
    depth cut as the file says; every size checked against the file."""
    from repro_torch.configs import get_arch
    spec = get_arch(config["run"]["port_arch"])
    base = (spec.smoke_cfg if config["run"].get("port_cfg") == "smoke"
            else spec.model_cfg)
    cfg = dataclasses.replace(base, n_layers=config["num_hidden_layers"])
    m = ref_model_of(config)
    got = dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
               head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab,
               rope_theta=float(cfg.rope_theta), norm_eps=float(cfg.norm_eps),
               n_experts=cfg.n_experts, top_k=cfg.top_k,
               capacity_factor=float(cfg.capacity_factor))
    want = dataclasses.asdict(m)
    if got != want:
        raise common.Unfit(f"the port's {spec.arch_id} is not the "
                           f"configuration file's: {got} != {want}")
    r = config["run"]
    return dataclasses.replace(spec, model_cfg=cfg,
                               param_dtype=r["param_dtype"],
                               microbatch=r.get("microbatch",
                                                spec.microbatch),
                               optimizer=r.get("optimizer", spec.optimizer))


def execution(config: dict, noise: dict | None, programmed: bool):
    """The port's `Execution`: every projection on the crossbar kernels,
    noise as the traffic states it."""
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.noise import DISABLED, NoiseModel
    from repro_torch.models.layers import Execution
    r = config["run"]
    nm = (NoiseModel(sigma_read=noise["sigma_read"],
                     sigma_prog_min=noise["sigma_prog_min"],
                     sigma_prog_max=noise["sigma_prog_max"])
          if noise else DISABLED)
    aimc = AimcConfig(tile_rows=r["tile_rows"], tile_cols=r["tile_cols"],
                      adc_alpha=r["adc_alpha"], input_scale=r["input_scale"],
                      noise=nm)
    return Execution(mode="aimc", aimc=aimc,
                     compute_dtype=r["compute_dtype"], programmed=programmed)
