"""Training CLI (PyTorch port of `repro/launch/train.py`).

    python -m repro_torch.launch.train --arch olmoe-1b-7b --layers 4 \\
        --steps 4 --global-batch 8 --seq-len 2048 [--exec aimc]
    python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --device cpu --steps 4 --ckpt-dir /tmp/run0
    python -m repro_torch.launch.train --arch xlstm-350m \\
        --global-batch 2 --seq-len 128 --steps 2
    python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke \\
        --device cpu --steps 4
    python -m repro_torch.launch.train --arch seamless-m4t-large-v2 \\
        --global-batch 2 --seq-len 4096 --steps 2
    python -m repro_torch.launch.train --arch olmoe-1b-7b --layers 4 \\
        --mesh 2x2 --steps 2 --global-batch 8 --seq-len 2048

The loop wires the substrate together as the reference's does, inside the
ambient mesh (`compat.use_mesh`): the restart-exact data pipeline
(`data.pipeline.host_batch`, placed over the data positions by
`make_global_array` when the mesh has more than one position), the
sharded train step (`launch.steps.make_train_step` on the mesh:
microbatched gradient accumulation, every block recomputed in the
backward), resume from the newest checkpoint in ``--ckpt-dir`` onto the
mesh, a straggler monitor and a heartbeat file, `resilient_step`,
`checkpoint.save_async` every ``--ckpt-every`` steps and a final save.
``--mesh`` is the reference's: ``DxM`` is (data, model), ``PxDxM`` (pod,
data, model). The mesh's positions fold round-robin onto ``--device``'s
devices (``cuda``: every visible card; one H100 holds all four positions
of ``2x2``), and the fold is printed as ``serve --mesh`` prints it.
Parameters are initialised in the arch's ``param_dtype``: arctic-480b's
bf16 leaves are drawn in f32 on the reference's keys and rounded one
matrix at a time. ``--exec aimc`` trains through the on-the-fly
crossbar (`core.aimc.aimc_linear_ste`): as in the reference CLI its
`AimcConfig` has noise DISABLED, so the run trains with quantization and
no noise; noise-aware training drives `make_train_step` with a noisy
`Execution`. ``lr`` is computed for the log only; the step runs at
``lr_scale=1.0``, as in the reference.

Every family trains. The enc-dec (audio) batch is the reference CLI's:
all-zero bf16 frames [gb, seq_len, d_model] (the frontend stub) and the
token stream cut to ``max(seq_len // 8, 64)`` target positions, as
`repro/launch/train.py:139-142` cuts it (its `steps.batch_shapes` uses
``seq_len // 4``; the CLI keeps the reference's own cut). At the
published depth those zero frames overflow the encoder's gradients (each
layernorm(0) scales its backward by 1/sqrt(eps)), in the reference as
here, and the first update turns the parameters non-finite.

Port flags: ``--device`` (default cuda; cpu must be asked for) and
``--layers N`` (a depth cut: xlstm takes an even N, whole mLSTM/sLSTM
pairs; rglru's N = 3k gives k units and no tail; the enc-dec family has
two stacks and refuses it). ``--no-xla-tuning`` is accepted and does
nothing (there are no XLA flags here). `main` returns a `TrainRun` with
every step's loss and the final trees whole on the controller's device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM, e.g. 2x2 or 2x1x2; the positions "
                         "fold onto --device's devices")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="0 = the train_4k cell's batch (or 4 with --smoke)")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--exec", dest="exec_mode", default="digital",
                    choices=["digital", "aimc"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-xla-tuning", action="store_true",
                    help="accepted for the reference's command lines; "
                         "nothing to tune here")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0 = all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu must be asked for explicitly")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the final trees (whole on the controller's
    device) and each step's loss and host wall time (a step's wall
    includes its device sync for the loss)."""
    params: dict
    opt_state: object
    losses: dict                 # step -> loss (float)
    step_s: dict                 # step -> host seconds
    start: int                   # first step run (> 0 after a resume)
    init_s: float


def main(argv=None) -> TrainRun:
    args = parse_args(argv)

    from repro_torch import compat
    from repro_torch.configs import ShapeCell, get_arch
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.launch.mesh import make_mesh, visible_devices
    from repro_torch.launch.serve import resolve_device
    from repro_torch.models.layers import Execution

    spec = get_arch(args.arch)
    device = resolve_device(args.device)
    try:
        shape = tuple(int(v) for v in args.mesh.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: expected DxM or PxDxM") \
            from None
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise SystemExit(f"--mesh {args.mesh!r}: expected DxM or PxDxM, "
                         f"each size >= 1")
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    mesh = make_mesh(shape, axes, visible_devices(str(device)))
    print(f"[train] {mesh.describe()}")
    cfg = spec.smoke_cfg if args.smoke else spec.model_cfg
    if args.layers:
        if spec.family == "audio":
            raise SystemExit(f"--layers: {spec.arch_id} has an encoder and a "
                             f"decoder stack (n_enc_layers, n_dec_layers); "
                             f"the depth cut takes one stack only")
        if not 0 < args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers} outside "
                             f"1..{cfg.n_layers}")
        if spec.module == "xlstm" and args.layers % 2:
            raise SystemExit(f"--layers {args.layers}: xlstm cuts whole "
                             f"mLSTM/sLSTM pairs, an even number of layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    spec = dataclasses.replace(spec, model_cfg=cfg)

    gb = args.global_batch or (4 if args.smoke else 256)
    sl = args.seq_len or (32 if args.smoke else 4096)
    cell = ShapeCell("train_cli", seq_len=sl, global_batch=gb, kind="train")
    cdtype = "float32" if args.smoke else "bfloat16"
    exe = (Execution(mode="aimc", aimc=AimcConfig(), compute_dtype=cdtype)
           if args.exec_mode == "aimc" else Execution(compute_dtype=cdtype))

    with compat.use_mesh(mesh):
        return _loop(args, spec, cfg, cell, exe, mesh, device, gb, sl)


def _loop(args, spec, cfg, cell, exe, mesh, device, gb, sl) -> TrainRun:
    from repro_torch.checkpoint import checkpoint
    from repro_torch.core.prng import PRNGKey
    from repro_torch.data.pipeline import (DataConfig, host_batch,
                                           make_global_array)
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.steps import make_step, train_specs
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.runtime.fault_tolerance import (Heartbeat,
                                                     StragglerMonitor,
                                                     resilient_step)

    bundle = make_step(spec, cell, mesh, exe)
    model = spec.model_module()
    t0 = time.time()
    params = model.init(PRNGKey(args.seed), cfg,
                        dtype=getattr(torch, spec.param_dtype), device=device)
    opt_state = make_optimizer(spec.optimizer)[0](params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.time() - t0

    start = 0
    if args.ckpt_dir:
        pspecs, ospecs = train_specs(mesh, params, opt_state)
        got, tree, _ = checkpoint.restore_latest(
            args.ckpt_dir, {"params": params, "opt": opt_state}, mesh,
            {"params": pspecs, "opt": ospecs})
        if got is not None:
            params, opt_state = tree["params"], tree["opt"]
            start = got
            print(f"[train] resumed from step {got}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=sl, global_batch=gb,
                      seed=args.seed)
    monitor = StragglerMonitor()
    hb = Heartbeat(os.path.join(args.ckpt_dir or ".", "heartbeat.json"))
    safe_step = resilient_step(bundle.fn)
    saves: list[threading.Thread] = []
    losses, step_s = {}, {}

    depth = (f"{cfg.n_enc_layers}+{cfg.n_dec_layers}L"
             if spec.family == "audio" else f"{cfg.n_layers}L")
    print(f"[train] {spec.arch_id} ({depth} d_model={cfg.d_model}) "
          f"{args.mesh} gb={gb} seq={sl} exec={args.exec_mode} on {device} "
          f"(init {init_s:.2f}s) steps {start}..{args.steps}")
    t_last = time.time()
    for step in range(start, args.steps):
        t_step = time.time()
        hbatch = host_batch(dcfg, step, 0, 1)
        batch = {k: torch.from_numpy(v).to(device) for k, v in hbatch.items()}
        if spec.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (gb, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
                device=device)
            batch["labels"][:, :cfg.n_patches] = -1
        if spec.family == "audio":
            tgt = max(sl // 8, 64)
            batch = {"frames": torch.zeros((gb, sl, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device=device),
                     "tokens": batch["tokens"][:, :tgt],
                     "labels": batch["labels"][:, :tgt]}
        if len(mesh.devices) > 1:
            batch = make_global_array(batch, mesh, sh.P(dp_axes(mesh), None))
        rng = torch.tensor([args.seed, step], dtype=torch.int64)
        lr = float(warmup_cosine(step, total=args.steps))
        params, opt_state, metrics = safe_step(params, opt_state, batch, rng)
        losses[step] = float(metrics["loss"])
        step_s[step] = time.time() - t_step
        if (step + 1) % args.log_every == 0 or step == start:
            dt = (time.time() - t_last) / args.log_every
            t_last = time.time()
            monitor.record(step, dt)
            hb.beat(step, loss=losses[step])
            print(f"  step {step + 1:6d} loss {losses[step]:8.4f} "
                  f"{step_s[step] * 1e3:8.1f} ms/step "
                  f"{gb * sl / max(step_s[step], 1e-9):,.0f} tok/s "
                  f"lr×{lr:.3f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            saves.append(checkpoint.save_async(
                args.ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                extra={"loss": losses[step]}))
    for t in saves:
        t.join()
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps,
                        {"params": params, "opt": opt_state})
    print("[train] done")
    return TrainRun(sh.whole_tree(params), sh.whole_tree(opt_state), losses,
                    step_s, start, init_s)


if __name__ == "__main__":
    main()
