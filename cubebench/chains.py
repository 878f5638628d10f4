"""The one general generator of the benchmark's traffic: it reads a mix's
``chain`` (``mixes/<name>.json``), draws each cube's parameters from the
seed, and drives the program, a cube at a time.

Each cube is a new ``SpectralCube`` over the resident input, as a user's
read gives it (a finiteness mask, the header's beam), and the chain's
operations run on it through the program's public entry points.  Each
operation is a step of its own, ``ops/<op>.py``, found by the name the mix
gives it, with ``run(chain, state, op, draw, held)`` and, where it needs
them, ``draw(rng, op)`` (its parameters for one cube) and ``setup(chain,
op)`` (what it holds over the run, with a ``remove()``).  A cube's
products are what the user keeps: host arrays and numbers, and the last
operation's cube, its data on the device.
"""

from __future__ import annotations

from . import found
from .cubegen import header_cards, host_rng


class Tap:
    """Keeps the value the wrapped callable last returned (the noise that
    ``run_pipeline`` takes from ``mad_std``), and returns it unchanged."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.original = owner.__dict__.get(name)
        fn = getattr(owner, name)
        self.value = None

        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.value = out
            return out
        tapped.__wrapped__ = fn
        setattr(owner, name, tapped)

    def remove(self):
        if self.original is None:
            delattr(self.owner, self.name)
        else:
            setattr(self.owner, self.name, self.original)


def beam(T, spec):
    """The program's ``Beam`` of (major arcsec, minor arcsec, pa deg)."""
    return T.Beam(T.Quantity(spec[0], "arcsec"), T.Quantity(spec[1], "arcsec"),
                  T.Quantity(spec[2], "deg"))


def step(name):
    """The program step ``ops/<name>.py``."""
    mod = found("ops", name)
    if mod is None:
        raise ValueError(f"no step ops/{name}.py for the operation {name!r}")
    return mod


class Chain:
    """The program driven by one mix over one configuration's input."""

    def __init__(self, config, mix, seed, inp):
        import spectral_cube_tpu_torch as T
        self.T = T
        self.config, self.mix, self.inp = config, mix, inp
        self.cards = header_cards(config)
        self.rng = host_rng(seed, 2)
        self.ops = mix["chain"]
        self.steps = [step(op["op"]) for op in self.ops]
        self.held = []
        for mod, op in zip(self.steps, self.ops):
            setup = getattr(mod, "setup", None)
            self.held.append(setup(self, op) if setup else None)

    def close(self):
        for held in reversed(self.held):
            if held is not None:
                held.remove()
        self.held = [None] * len(self.steps)

    def draw(self):
        """The next cube's parameters, drawn from the seed in order: one
        dict an operation."""
        return [mod.draw(self.rng, op) if hasattr(mod, "draw") else {}
                for mod, op in zip(self.steps, self.ops)]

    def new_cube(self):
        import torch
        from spectral_cube_tpu_torch.io.fits_low import Header
        T = self.T
        header = Header(list(self.cards))
        wcs = T.WCS(header=header)
        mask = T.LazyMask(torch.isfinite, data=self.inp, wcs=wcs)
        return T.SpectralCube(self.inp, wcs, mask=mask,
                              meta={"BUNIT": "Jy/beam"}, header=header)

    def run(self, draws):
        """One cube through the chain: its products, complete (host
        products on the host, the cube's data synchronised)."""
        state = {"cube": self.new_cube(), "products": {}}
        for mod, op, d, held in zip(self.steps, self.ops, draws, self.held):
            mod.run(self, state, op, d, held)
        products = state["products"]
        products["cube"] = state["cube"]._data
        _synchronize(products["cube"])
        return products


def _synchronize(t):
    import torch
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
