"""Paper workloads as cost-model IR (paper §VII-IX: Figs. 6, 9, 12); a copy
of `repro/core/workloads.py`, which imports no framework.

Builders return ``{case_name: Workload}`` dicts covering every digital and
AIMC-mapped case of the three exploration studies, plus the loose-coupling
variant of §VII-B. The executable twins of these networks live in
``models/paper_nets.py``; this module is the timing/energy view.

Phase structure: stages inside one phase run on different cores in parallel
(column-split layers); phases chain sequentially per inference. The CNN uses
fine-grained position-level pipelining instead (``pipelined=True``).
"""

from __future__ import annotations

from repro_torch.core.costmodel import Op, Stage, Workload

INT8 = 1  # bytes per weight/activation element (paper uses int8_t end-to-end)


# ---------------------------------------------------------------------------
# Exploration one: MLP (1024, 1024), ReLU (paper Fig. 6)
# ---------------------------------------------------------------------------

def mlp_workloads(n: int = 1024) -> dict[str, Workload]:
    w_bytes = 2 * n * n * INT8
    act = 3 * n * INT8
    half = n // 2

    def digital(cores: int) -> Workload:
        if cores == 1:
            ops = (Op("load", bytes=n),
                   Op("mvm", k=n, n=n), Op("elemwise", fn="relu", elems=n),
                   Op("mvm", k=n, n=n), Op("elemwise", fn="relu", elems=n),
                   Op("store", bytes=n))
            phases = ((Stage(ops, weights_bytes=w_bytes, act_bytes=act),),)
        elif cores == 2:
            phases = (
                (Stage((Op("load", bytes=n), Op("mvm", k=n, n=n),
                        Op("elemwise", fn="relu", elems=n)),
                       weights_bytes=n * n, act_bytes=2 * n),),
                (Stage((Op("comm", bytes=n), Op("mvm", k=n, n=n),
                        Op("elemwise", fn="relu", elems=n), Op("store", bytes=n)),
                       weights_bytes=n * n, act_bytes=2 * n),),
            )
        else:  # 4 cores: each layer column-split across two cores
            l1 = tuple(
                Stage((Op("load", bytes=n) if i == 0 else Op("comm", bytes=n),
                       Op("mvm", k=n, n=half),
                       Op("elemwise", fn="relu", elems=half)),
                      weights_bytes=n * half, act_bytes=2 * n)
                for i in range(2))
            l2 = tuple(
                Stage((Op("comm", bytes=half), Op("comm", bytes=half),
                       Op("mvm", k=n, n=half),
                       Op("elemwise", fn="relu", elems=half),
                       Op("store", bytes=half)),
                      weights_bytes=n * half, act_bytes=2 * n)
                for _ in range(2))
            phases = (l1, l2)
        return Workload(f"mlp_dig_{cores}c", phases)

    def analog(case: int) -> Workload:
        if case in (1, 2):
            # single core, both layers in one tile; case 2 halves the word
            # lines so each MVM needs two CM_PROCESS activations (paper §VII-B)
            tile_rows = n if case == 1 else n // 2
            ops = (Op("load", bytes=n),
                   Op("mvm", k=n, n=n, aimc=True),
                   Op("elemwise", fn="relu", elems=n),
                   Op("mvm", k=n, n=n, aimc=True),
                   Op("elemwise", fn="relu", elems=n),
                   Op("store", bytes=n))
            return Workload(f"mlp_ana_case{case}", ((Stage(ops, act_bytes=act),),),
                            tile_rows=tile_rows)
        if case == 3:  # one layer per core, mutex hand-off between them
            phases = (
                (Stage((Op("load", bytes=n), Op("mvm", k=n, n=n, aimc=True),
                        Op("elemwise", fn="relu", elems=n))),),
                (Stage((Op("comm", bytes=n), Op("mvm", k=n, n=n, aimc=True),
                        Op("elemwise", fn="relu", elems=n), Op("store", bytes=n))),),
            )
            return Workload("mlp_ana_case3", phases, tile_rows=n)
        # case 4: each layer split over two cores; second layer consumes both
        # halves from both producers (two comms + mutexes per consumer).
        l1 = tuple(
            Stage((Op("load", bytes=n) if i == 0 else Op("comm", bytes=n),
                   Op("mvm", k=n, n=half, aimc=True),
                   Op("elemwise", fn="relu", elems=half)))
            for i in range(2))
        l2 = tuple(
            Stage((Op("comm", bytes=half), Op("comm", bytes=half),
                   Op("mvm", k=n, n=half, aimc=True),
                   Op("elemwise", fn="relu", elems=half),
                   Op("store", bytes=half)))
            for _ in range(2))
        return Workload("mlp_ana_case4", (l1, l2), tile_rows=n)

    def analog_fused(case: int) -> Workload:
        """Kernel-v2 fused-epilogue twins of cases 1/3: each relu rides its
        layer's dequeue loop (`Op(..., epilogue="relu")`) instead of running
        as a separate elemwise pass — matches
        `schedule.mlp_schedule(..., fuse_epilogue=True)` op for op."""
        if case == 1:
            ops = (Op("load", bytes=n),
                   Op("mvm", k=n, n=n, aimc=True, epilogue="relu"),
                   Op("mvm", k=n, n=n, aimc=True, epilogue="relu"),
                   Op("store", bytes=n))
            return Workload("mlp_ana_case1_fused", ((Stage(ops, act_bytes=act),),),
                            tile_rows=n)
        phases = (
            (Stage((Op("load", bytes=n),
                    Op("mvm", k=n, n=n, aimc=True, epilogue="relu"))),),
            (Stage((Op("comm", bytes=n),
                    Op("mvm", k=n, n=n, aimc=True, epilogue="relu"),
                    Op("store", bytes=n))),),
        )
        return Workload("mlp_ana_case3_fused", phases, tile_rows=n)

    out = {f"dig_{c}c": digital(c) for c in (1, 2, 4)}
    out |= {f"ana_case{i}": analog(i) for i in (1, 2, 3, 4)}
    out |= {f"ana_case{i}_fused": analog_fused(i) for i in (1, 3)}
    # §VII-B loosely-coupled variant: case-1 mapping over the I/O bus.
    loose = analog(1)
    out["ana_loose"] = Workload("mlp_ana_loose", loose.phases,
                                coupling="loose", tile_rows=n)
    return out


# ---------------------------------------------------------------------------
# Exploration two: LSTM, PTB character model (paper Fig. 9, Table II)
# ---------------------------------------------------------------------------

def _lstm_cell_elemwise(nh: int, frac: float = 1.0) -> tuple[Op, ...]:
    """The nine linear-complexity cell ops (paper §VIII-D): 3 sigmoid gates,
    tanh(g), c = f*c + i*g, tanh(c), h = o*tanh(c)."""
    m = int(nh * frac)
    return (Op("elemwise", fn="sigmoid", elems=3 * m),
            Op("elemwise", fn="tanh", elems=m),
            Op("elemwise", fn="mul", elems=2 * m),
            Op("elemwise", fn="add", elems=m),
            Op("elemwise", fn="tanh", elems=m),
            Op("elemwise", fn="mul", elems=m))


def lstm_workloads(nh: int, x: int = 50, y: int = 50) -> dict[str, Workload]:
    kin = nh + x                      # concatenated [h, x]
    cell_w = 4 * kin * nh * INT8
    dense_w = nh * y * INT8
    act = (kin + nh + y) * INT8
    q = 4                             # cell slices in the quin-core cases

    def digital(cores: int) -> Workload:
        cell_ops = (Op("load", bytes=x), Op("mvm", k=kin, n=4 * nh),
                    *_lstm_cell_elemwise(nh))
        dense_ops = (Op("mvm", k=nh, n=y),
                     Op("elemwise", fn="softmax", elems=y), Op("store", bytes=y))
        if cores == 1:
            return Workload(f"lstm{nh}_dig_1c",
                            ((Stage(cell_ops + dense_ops,
                                    weights_bytes=cell_w + dense_w,
                                    act_bytes=act),),))
        if cores == 2:
            return Workload(f"lstm{nh}_dig_2c", (
                (Stage(cell_ops, weights_bytes=cell_w, act_bytes=act),),
                (Stage((Op("comm", bytes=nh),) + dense_ops,
                       weights_bytes=dense_w, act_bytes=act),)))
        slices = tuple(
            Stage((Op("load", bytes=x),
                   *(Op("comm", bytes=nh // q) for _ in range(q - 1)),  # h feedback
                   Op("mvm", k=kin, n=4 * nh // q),
                   *_lstm_cell_elemwise(nh, 1 / q), Op("comm", bytes=nh // q)),
                  weights_bytes=cell_w // q, act_bytes=act)
            for _ in range(q))
        dense = Stage((Op("comm", bytes=nh),) + dense_ops,
                      weights_bytes=dense_w, act_bytes=act)
        return Workload(f"lstm{nh}_dig_5c", (slices, (dense,)))

    def analog(case: int) -> Workload:
        # paper Table II-(B): case 1 packs cell+dense in one big tile, case 2
        # uses a snugger tile, case 3 splits layers across two cores, case 4
        # gate-slices the cell across four cores + a dense core.
        tile_rows = {1: 2 * kin, 2: kin + 50, 3: kin + 50, 4: kin + 50}[case]
        cell_mvm = Op("mvm", k=kin, n=4 * nh, aimc=True)
        dense_mvm = Op("mvm", k=nh, n=y, aimc=True)
        soft = (Op("elemwise", fn="softmax", elems=y), Op("store", bytes=y))
        if case in (1, 2):
            ops = (Op("load", bytes=x), cell_mvm, *_lstm_cell_elemwise(nh),
                   dense_mvm, *soft)
            return Workload(f"lstm{nh}_ana_case{case}",
                            ((Stage(ops, act_bytes=act),),), tile_rows=tile_rows)
        if case == 3:
            return Workload(f"lstm{nh}_ana_case3", (
                (Stage((Op("load", bytes=x), cell_mvm,
                        *_lstm_cell_elemwise(nh))),),
                (Stage((Op("comm", bytes=nh), dense_mvm, *soft)),)),
                tile_rows=tile_rows)
        # case 4: each cell core queues the full [h, x], dequeues its gate
        # slice; h slices are exchanged all-to-all for the recurrence.
        slices = tuple(
            Stage((Op("load", bytes=x),
                   *(Op("comm", bytes=nh // q) for _ in range(q - 1)),  # h feedback
                   Op("mvm", k=kin, n=4 * nh // q, aimc=True),
                   *_lstm_cell_elemwise(nh, 1 / q), Op("comm", bytes=nh // q)))
            for _ in range(q))
        dense = Stage((Op("comm", bytes=nh), dense_mvm, *soft))
        return Workload(f"lstm{nh}_ana_case4", (slices, (dense,)),
                        tile_rows=tile_rows)

    out = {f"dig_{c}c": digital(c) for c in (1, 2, 5)}
    out |= {f"ana_case{i}": analog(i) for i in (1, 2, 3, 4)}
    return out


# ---------------------------------------------------------------------------
# Exploration three: CNN-F/M/S (paper Fig. 12, Chatfield et al. [42])
# ---------------------------------------------------------------------------

# (cin, ksize, cout, out_hw, lrn, pool_out_hw) per conv layer; dense dims.
_CNN_SPECS = {
    "F": dict(convs=[(3, 11, 64, 54, True, 27), (64, 5, 256, 27, True, 13),
                     (256, 3, 256, 13, False, 13), (256, 3, 256, 13, False, 13),
                     (256, 3, 256, 13, False, 6)],
              dense=[(6 * 6 * 256, 4096), (4096, 4096), (4096, 1000)]),
    "M": dict(convs=[(3, 7, 96, 109, True, 54), (96, 5, 256, 52, True, 26),
                     (256, 3, 512, 26, False, 26), (512, 3, 512, 26, False, 26),
                     (512, 3, 512, 26, False, 13)],
              dense=[(13 * 13 * 512, 4096), (4096, 4096), (4096, 1000)]),
    "S": dict(convs=[(3, 7, 96, 109, True, 36), (96, 5, 256, 34, True, 17),
                     (256, 3, 512, 17, False, 17), (512, 3, 512, 17, False, 17),
                     (512, 3, 512, 17, False, 5)],
              dense=[(5 * 5 * 512, 4096), (4096, 4096), (4096, 1000)]),
}


def cnn_workloads(variant: str) -> dict[str, Workload]:
    spec = _CNN_SPECS[variant]

    def build(aimc: bool) -> Workload:
        stages = []
        prev_hw, prev_c = 224, 3
        for i, (cin, k, cout, hw, lrn, pool_hw) in enumerate(spec["convs"]):
            kdim = k * k * cin
            ops = []
            if i == 0:
                ops.append(Op("load", bytes=224 * 224 * 3))
            else:
                ops.append(Op("comm", bytes=prev_hw * prev_hw * prev_c))
            ops.append(Op("mvm", k=kdim, n=cout, count=hw * hw,
                          aimc=aimc, conv=True))
            ops.append(Op("elemwise", fn="relu", elems=hw * hw * cout))
            if lrn:
                ops.append(Op("elemwise", fn="lrn", elems=hw * hw * cout))
            if pool_hw != hw:
                ops.append(Op("elemwise", fn="maxpool", elems=hw * hw * cout))
            stages.append(Stage(
                tuple(ops),
                weights_bytes=0 if aimc else kdim * cout * INT8,
                act_bytes=(prev_hw * prev_hw * prev_c + hw * hw * cout) * INT8))
            prev_hw, prev_c = pool_hw, cout
        # dense layers: digital in BOTH mappings (paper §IX-A)
        for j, (kin, nout) in enumerate(spec["dense"]):
            ops = [Op("comm", bytes=kin if j == 0 else 0),
                   Op("mvm", k=kin, n=nout),
                   Op("elemwise", fn="softmax" if j == 2 else "relu", elems=nout)]
            if j == 2:
                ops.append(Op("store", bytes=nout))
            stages.append(Stage(tuple(ops), weights_bytes=kin * nout * INT8,
                                act_bytes=(kin + nout) * INT8))
        name = f"cnn{variant}_{'ana' if aimc else 'dig'}"
        phases = tuple((s,) for s in stages)
        return Workload(name, phases, pipelined=True, tile_rows=1024)

    return {"dig": build(False), "ana": build(True)}
