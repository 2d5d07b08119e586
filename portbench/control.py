"""The control of `correct`, at a cell's own size, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process: the cell's tables, every query of its
mix with each substitution set once through the port's plan (the
program's readings) and once through the plain reference computed in the
next lower precision than the configuration states (`control` in the
configuration file: float32 for float64 money, int32 for int64 sums),
both judged against the reference at the stated precision by the
comparison that decides `correct`. Prints one JSON line a seed:
{"seed", "program": checks, "control": checks}. The benchmark's own
runs never run this; the limits in the configuration files were set
from its readings (PERF.md).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)


def readings(cell, seed: int, device: str = "cuda") -> dict:
    import gc

    import torch

    from portbench.harness import check, params, stream, tables
    from portbench.harness.cell import ACC
    dev = torch.device(device)
    gen = cell.generator().generate(cell.config, seed, dev)
    port = tables.to_port(gen)
    plans, refs = cell.plans(), cell.references()
    sets = params.draw_sets(cell.mix, seed)
    ctx = stream.Ctx(dev)
    got = []
    for q, k in params.instances(cell.mix, seed):
        a = stream.Answer(q, k, 0.0)
        a.result = check.normalize(plans[q].run(port, sets[q][k], ctx))
        got.append(a)
    del port
    gc.collect()
    acc, low = ACC[cell.config["accumulate"]], ACC[cell.config["control"]]
    wants, ctl = {}, []
    for q, k in params.instances(cell.mix, seed):
        wants[(q, k)] = check.normalize(refs[q].run(gen, sets[q][k], acc))
        a = stream.Answer(q, k, 0.0)
        a.result = check.normalize(refs[q].run(gen, sets[q][k], low))
        ctl.append(a)
    limits = cell.config["limits"]
    return {"seed": seed,
            "program": check.judge(got, wants, limits)[1],
            "control": check.judge(ctl, wants, limits)[1]}


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench.harness.spec import load_cell
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for s in args.seeds:
        print(json.dumps(readings(cell, s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
