"""``run_pipeline`` on the cube: convolved to the target beam, masked at
``snr_threshold`` times the noise, moments, statistics, and reprojected
onto the input grid shifted by (dx, dy) pixels, drawn for each cube from
``target_shift_px``.  ``noise`` is ``"mad_std"`` (the program takes it
from ``SpectralCube.mad_std``, and the value it took is kept for the
check) or a number in the cube's unit, handed over as
``noise_estimate``."""

import numpy as np

from cubebench.chains import Tap, beam
from cubebench.cubegen import shifted_cards


def setup(chain, op):
    if op["noise"] == "mad_std":
        return Tap(chain.T.SpectralCube, "mad_std")
    return None


def draw(rng, op):
    lo, hi = op["target_shift_px"]
    dx, dy = (float(v) for v in rng.uniform(lo, hi, 2))
    return {"dx": dx, "dy": dy}


def run(chain, state, op, draw, tap):
    from spectral_cube_tpu_torch.io.fits_low import Header
    T = chain.T
    target = chain.config["target_beam"] if op["target_beam"] == "config" \
        else op["target_beam"]
    header = Header(shifted_cards(chain.cards, draw["dx"], draw["dy"]))
    noise = None if tap is not None else float(op["noise"])
    res = T.run_pipeline(state["cube"], snr_threshold=op["snr_threshold"],
                         target_beam=beam(T, target), target_header=header,
                         noise_estimate=noise)
    m0, m1, lw = res["moments"]
    st = res["statistics"]
    products = {
        "mom0": np.asarray(m0.value), "mom1": np.asarray(m1.value),
        "linewidth": np.asarray(lw.value),
        "statistics": {k: float(getattr(v, "value", v))
                       for k, v in st.items()}}
    if tap is not None:
        products["sigma"] = float(tap.value.value)
    state["products"].update(products)
    state["cube"] = res["cube"]
