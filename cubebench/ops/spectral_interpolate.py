"""``SpectralCube.spectral_interpolate`` onto every ``every``-th channel
of the cube's spectral axis, smoothed first with the kernel of the last
``spectral_smooth`` where ``smooth_kernel`` is ``"same"``."""


def run(chain, state, op, draw, held):
    cube = state["cube"]
    kern = state["kernel"] if op.get("smooth_kernel") == "same" else None
    grid = cube.spectral_axis[::int(op["every"])]
    state["cube"] = cube.spectral_interpolate(grid, smooth_kernel=kern)
