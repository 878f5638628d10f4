"""The two readings from which a cell's limits (``limits/<cell>.json``)
are set, read on the card at the cell's own size, one seed after another
in one process:

- ``--side program``: a sound run of the program, a cube of the cell's
  chain compared with the reference as a run compares the window's last
  cube (the lower readings);
- ``--side control``: the control, the reference computed in TF32 (the
  precision below the configurations' IEEE float32,
  ``reference/numerics.py``) put in the program's place (the upper
  readings).

The benchmark's runs do not run it.

    python cubebench/control.py --workload <cell> --side control \\
        --seeds 11 12 13

Prints one JSON line a seed: {"workload", "side", "seed", "correct",
"left_out", "compared": {name: number}}.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control"),
                   default="control")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    from cubebench import harness
    from cubebench.chains import Chain
    from cubebench.cubegen import make_cube
    from cubebench.reference import chains as ref
    from cubebench.reference.numerics import TF32
    if not torch.cuda.is_available():
        print("control.py reads on the card; CUDA is missing",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        inp = make_cube(cell.shape, seed, dev)
        chain = Chain(cell.config, cell.mix, seed, inp)
        try:
            draws = chain.draw()
            if args.side == "program":
                got = chain.run(draws)
        finally:
            chain.close()
        if args.side == "control":
            got = ref.as_program(
                ref.products(cell.config, cell.mix, inp, draws, TF32))
        del chain
        gc.collect()
        torch.cuda.empty_cache()
        correct, compared, left_out = harness.check(cell, inp, got, draws)
        print(json.dumps({"workload": cell.name, "side": args.side,
                          "seed": seed, "correct": correct,
                          "left_out": left_out,
                          "compared": {k: v["value"]
                                       for k, v in compared.items()}}),
              flush=True)
        del inp, got
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
