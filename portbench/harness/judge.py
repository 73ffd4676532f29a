"""The numbers that decide `correct`, each against its limit from the
cell's limits file.

Training: the loss of each checked step, the norm of each leaf's first
gradient as the optimizer got it (its first moment after one step over
``1 - b1``), and the norm of each leaf's change after the checked steps;
each by the worst leaf as the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and
of the median leaf. A leaf whose reference gradient is under a
thousandth of the median leaf's moves under Adam by round-off alone and
is left out of the change.

Serving: the widest gap by which a served token's logit lies below the
reference's best logit at its position.

Both: `digital_gap`, the widest gap of a checked digital stage to its
f64 recomputation from the inputs it received (`stages.py`), which
reads the precision the stages computed in."""

from __future__ import annotations

import statistics

import torch

TINY_GRAD = 1e-3


def leaf_norms(tree: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.to(torch.float32)))
            for n, t in tree.items()}


def worst_gap(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    names = [n for n in ref if n not in skip]
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst or not at:
            worst, at = gap, n
    return worst, at


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grads": {leaf: norm},
    "changes": {leaf: norm}} -> the three numbers compared."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    med = statistics.median(ref["grads"].values())
    tiny = {n for n, v in ref["grads"].items() if v < TINY_GRAD * med}
    grad, grad_at = worst_gap(prog["grads"], ref["grads"])
    step, step_at = worst_gap(prog["changes"], ref["changes"], tiny)
    st = prog.get("stages", {})
    return {"loss_gap": max(losses), "grad_gap": grad, "step_gap": step,
            "digital_gap": st.get("digital_gap"),
            "where": {"grad": grad_at, "step": step_at,
                      "excluded": sorted(tiny),
                      "digital": st.get("digital")}}


def checks(readings: dict, limits: dict) -> list:
    """One entry per number with a limit: name, value, limit, ok."""
    out = []
    for name, lim in limits["limits"].items():
        v = readings.get(name)
        ok = v is not None and v == v and v <= lim
        out.append({"name": name, "value": v, "limit": lim, "ok": ok})
    return out


def logit_gap(logits: torch.Tensor, served: torch.Tensor) -> float:
    """max over positions of best logit minus the served token's."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, served.long()[:, None])[:, 0]
    return float((best - got).max())


def readings_of(driver, cell, seed: int, got: dict, dev):
    """(readings, what was judged) of a run's outputs: the reference runs
    once the program's state is freed."""
    if cell.traffic["kind"] == "train":
        ref_out = driver.reference_side(cell, seed, dev)
        return train_readings(got, ref_out), (
            f"{len(ref_out['losses'])} steps")
    readings, n = driver.judge_served(cell, seed, got, dev)
    return readings, f"{n} served tokens"
