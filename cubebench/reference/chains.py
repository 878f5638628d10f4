"""The reference of a mix's chain, composed by walking the chain: each
operation is a reference step of its own, ``reference/ops/<op>.py``, found
by the name the mix gives it.

A step of ``KIND`` ``"spectra"`` works on each spectrum alone
(``prepare(op, ctx)`` once, ``nchan(n, params)``, ``apply(block, params,
arith)`` on a block of whole spectra); consecutive such steps run
together, a block of rows at a time.  A step of ``KIND`` ``"cube"`` takes
the whole cube (``apply(x, config, op, draw, arith)`` -> (products,
stream)) and compares its products itself (``compare(got, want)``).  The
last step's cube is compared a block at a time (``stream.compare``)."""

from __future__ import annotations

from .. import found
from .numerics import IEEE
from .stream import Stream, compare as compare_cube, spectra


def step(name):
    """The reference step ``reference/ops/<name>.py``."""
    mod = found("reference/ops", name)
    if mod is None:
        raise ValueError(f"no reference step reference/ops/{name}.py for "
                         f"the operation {name!r}")
    return mod


def products(config, mix, inp, draws, arith=IEEE):
    """The reference of one cube of ``mix`` on ``inp`` with the cube's
    ``draws`` (one dict an operation): {"steps": [(step, products)] of
    the steps that keep products, "cube": the last cube's stream}."""
    stream, pending, kept, ctx = Stream.of(inp), [], [], {}
    for op, draw in zip(mix["chain"], draws):
        mod = step(op["op"])
        if mod.KIND == "spectra":
            pending.append((mod, mod.prepare(op, ctx)))
            continue
        if pending:
            stream, pending = spectra(stream, pending, arith), []
        x, _ = stream.materialize()
        prods, stream = mod.apply(x, config, op, draw, arith)
        del x
        kept.append((mod, prods))
    if pending:
        stream = spectra(stream, pending, arith)
    return {"steps": kept, "cube": stream}


def compare(got, want):
    """({name: number}, {name: count left out}) of the program's products
    ``got`` against the reference's ``want`` (:func:`products`)."""
    numbers, left_out = {}, {}
    for mod, prods in want["steps"]:
        n, left = mod.compare(got, prods)
        numbers.update(n)
        left_out.update(left)
    n, left = compare_cube(got["cube"], want["cube"])
    numbers.update(n)
    left_out.update(left)
    return numbers, left_out


def as_program(want):
    """The reference's products in the program's form (one dict, the cube
    whole): the control, put in the program's place."""
    got = {k: v for _, prods in want["steps"] for k, v in prods.items()}
    got["cube"], _ = want["cube"].materialize()
    return got
