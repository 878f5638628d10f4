"""``SpectralCube.sigma_clip_spectrally`` at ``sigma`` for ``maxiters``
iterations."""


def run(chain, state, op, draw, held):
    state["cube"] = state["cube"].sigma_clip_spectrally(
        op["sigma"], maxiters=int(op["maxiters"]))
