"""How many device records a profiler trace keeps, session after session,
on one card.

    python3 tools/profiler_sessions.py

For each of BIG and SMALL, a fresh process runs one session of that many
element-wise kernels, then SESSIONS short sessions of a marked run (one
``neg`` kernel, MARKED adds, one ``abs`` kernel), each under
``spectral_cube_tpu_torch.profiling.trace``.  It prints one JSON line a
process: for each short session the kernels the trace kept of those
launched, and whether the first (``neg``) and the last (``abs``) are
among them; the card's name and power limit come first.  Needs one CUDA
device.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BIG = 100000
SMALL = 3000
SESSIONS = 4
MARKED = 100


def kernels(events):
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def scenario(first):
    """A session of ``first`` kernels, then SESSIONS marked ones."""
    import torch
    from spectral_cube_tpu_torch import profiling
    dev = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=dev)
    logdir = tempfile.mkdtemp()
    with profiling.trace(logdir, device=dev):
        for _ in range(first):
            x + 1.0
    kept_first = len(kernels(profiling.trace.last.events))
    os.remove(profiling.trace.last.path)
    rows = []
    for _ in range(SESSIONS):
        try:
            with profiling.trace(logdir, device=dev):
                x.neg()
                for _ in range(MARKED):
                    x + 1.0
                x.abs()
        except RuntimeError:  # the trace kept no device record at all
            pass
        names = kernels(profiling.trace.last.events)
        os.remove(profiling.trace.last.path)
        rows.append({"kept": len(names), "launched": MARKED + 2,
                     "first": any("neg" in n.lower() for n in names),
                     "last": any("abs" in n.lower() for n in names)})
    os.rmdir(logdir)
    print(json.dumps({"first_session": first, "kept": kept_first,
                      "then": rows}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("profiler_sessions: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    spawn = multiprocessing.get_context("spawn")
    for first in (BIG, SMALL):
        p = spawn.Process(target=scenario, args=(first,))
        p.start()
        p.join(600)
        if p.exitcode != 0:
            p.kill()
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
