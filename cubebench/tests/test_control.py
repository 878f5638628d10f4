"""The control, the reference computed in TF32 (the precision below the
configurations' IEEE float32) put in the program's place, comes out not
correct under every cell's limits, at a tiny size on the CPU.  The
benchmark's runs do not run it; ``control.py`` reads it on the card at the
cells' own sizes."""

import pytest
import torch

from cubebench import chains, cubegen, harness
from cubebench.reference import chains as ref
from cubebench.reference.numerics import TF32
from cubebench.tests.test_faults import TINY


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_the_control_is_not_correct(root, name, seed):
    cell = harness.load_cell(name, root)
    cell.config["shape"] = list(TINY[name])
    inp = cubegen.make_cube(cell.shape, seed, torch.device("cpu"))
    chain = chains.Chain(cell.config, cell.mix, seed, inp)
    try:
        draw = chain.draw()
    finally:
        chain.close()
    control = ref.as_program(ref.products(cell.config, cell.mix, inp, draw,
                                          TF32))
    correct, compared, _ = harness.check(cell, inp, control, draw)
    assert not correct, compared
