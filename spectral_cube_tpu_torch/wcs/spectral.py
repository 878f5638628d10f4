"""Spectral axis conversions as WCS rewrites.

Re-derivation of the reference's spectral-axis machinery
(``spectral_cube/spectral_axis.py:200-410``): converting a
spectral WCS between frequency / wavelength / velocity (radio, optical,
relativistic conventions) rewrites CRVAL/CDELT/CTYPE/CUNIT, keeping the
*sampled* (linear) variable recorded in the FITS algorithm code (e.g.
``VOPT-F2W`` = optical velocity values on an axis sampled linearly in
frequency), so round-trips are exact.

All transforms are implemented analytically (value + derivative) with
frequency as the hub variable; formulas are the standard Doppler relations
(Greisen et al. 2006).
"""

from __future__ import annotations

import numpy as np

from ..units import Unit, Quantity, UnitConversionError, c
# re-exported here for parity with the reference's spectral_axis module
# (reference spectral_axis.py:172-197)
from ..units import doppler_z, doppler_beta, doppler_gamma  # noqa: F401
from .core import WCS

__all__ = [
    "convert_spectral_axis",
    "determine_ctype_from_vconv",
    "determine_vconv_from_ctype",
    "air_to_vac",
    "vac_to_air",
    "air_to_vac_deriv",
]

# velocity convention names
RADIO, OPTICAL, RELATIVISTIC = "radio", "optical", "relativistic"

_CONV_ALIASES = {
    "radio": RADIO, "RADIO": RADIO, "VRAD": RADIO, "F": RADIO, "FREQ": RADIO,
    "ENER": RADIO, "WAVN": RADIO,
    "optical": OPTICAL, "OPTICAL": OPTICAL, "VOPT": OPTICAL, "W": OPTICAL,
    "WAVE": OPTICAL,
    "relativistic": RELATIVISTIC, "RELATIVE": RELATIVISTIC,
    "VREL": RELATIVISTIC, "speed": RELATIVISTIC, "V": RELATIVISTIC,
    "VELO": RELATIVISTIC,
}

SPEED_CTYPE = {RADIO: "VRAD", OPTICAL: "VOPT", RELATIVISTIC: "VELO"}
SPEED_CHAR = {RADIO: "F", OPTICAL: "W", RELATIVISTIC: "V"}
ROOT_CHAR = {"FREQ": "F", "ENER": "F", "WAVN": "F", "WAVE": "W", "AWAV": "A",
             "VRAD": "F", "VOPT": "W", "VELO": "V"}
PHYS_CTYPE = {"frequency": "FREQ", "length": "WAVE"}
CHAR_PHYS = {"F": "frequency", "W": "length", "V": "speed",
             "A": "air wavelength"}


def parse_velocity_convention(vc):
    if vc is None:
        return None
    return _CONV_ALIASES.get(str(vc), None)


def determine_vconv_from_ctype(ctype: str):
    ct = ctype.strip().upper()
    if len(ct) <= 4:
        return parse_velocity_convention(ct[:4])
    return parse_velocity_convention(ct[7])


def determine_ctype_from_vconv(ctype: str, unit, velocity_convention=None):
    """Output CTYPE for converting an axis with ``ctype`` to ``unit``.

    Mirrors the grammar of the reference implementation
    (``spectral_axis.py:101-156``): the sampled-variable char is inherited
    from the input ctype; the output root comes from the target physical
    type (+ velocity convention for speeds)."""
    unit = Unit.parse(unit) if isinstance(unit, str) else unit
    ct = ctype.strip().upper()
    root_in = ct[:4]
    if len(ct) > 4:
        in_char = ct[5]
    else:
        in_char = ROOT_CHAR.get(root_in, "F")

    phys = unit.physical_type
    if phys == "speed":
        vc = parse_velocity_convention(velocity_convention)
        if vc is None and velocity_convention is not None:
            # explicitly given but unrecognized (reference
            # spectral_axis.py determine_ctype_from_vconv raises)
            raise ValueError("Velocity convention must be radio, optical, "
                             "or relativistic.")
        if vc is None:
            if ct[0] == "V":
                return ct  # velocity -> velocity keeps its convention
            raise ValueError("A velocity convention must be specified")
        out_root = SPEED_CTYPE[vc]
        out_char = SPEED_CHAR[vc]
    elif phys in ("frequency", "length"):
        out_root = PHYS_CTYPE[phys]
        out_char = ROOT_CHAR[out_root]
    else:
        raise UnitConversionError(
            f"unit {unit} is not a spectral unit")

    if in_char == out_char:
        return out_root
    return f"{out_root}-{in_char}2{out_char}"


# ----------------------------------------------------------------------------
# analytic transforms: root variable (SI) <-> frequency (Hz), with derivative
# ----------------------------------------------------------------------------
def _to_freq(root, rest_freq):
    """Return (f, dfdx): x in SI of `root` -> frequency [Hz] and derivative."""
    if root in ("FREQ",):
        return (lambda x: x), (lambda x: np.ones_like(np.asarray(x, float)))
    if root == "WAVN":
        return (lambda x: x * c), (lambda x: np.full_like(np.asarray(x, float), c))
    if root == "ENER":
        from ..units import h
        return (lambda x: x / h), (lambda x: np.full_like(np.asarray(x, float), 1.0 / h))
    if root in ("WAVE",):
        return (lambda x: c / x), (lambda x: -c / np.asarray(x, float) ** 2)
    if root == "AWAV":
        def f(x):
            return c / air_to_vac(x)

        def d(x):
            lv = air_to_vac(x)
            return -c / lv ** 2 * air_to_vac_deriv(x)
        return f, d
    if rest_freq is None:
        raise ValueError("rest frequency required for velocity conversions")
    f0 = rest_freq
    if root == "VRAD":
        return ((lambda x: f0 * (1.0 - x / c)),
                (lambda x: np.full_like(np.asarray(x, float), -f0 / c)))
    if root == "VOPT":
        return ((lambda x: f0 / (1.0 + x / c)),
                (lambda x: -f0 / c / (1.0 + np.asarray(x, float) / c) ** 2))
    if root == "VELO":
        def f(x):
            b = np.asarray(x, float) / c
            return f0 * np.sqrt((1.0 - b) / (1.0 + b))

        def d(x):
            b = np.asarray(x, float) / c
            return -f0 / c * np.sqrt((1.0 - b) / (1.0 + b)) / (1.0 - b ** 2)
        return f, d
    raise ValueError(f"unknown spectral root {root!r}")


def _from_freq(root, rest_freq):
    """Return (g, dgdf): frequency [Hz] -> root SI value and derivative."""
    if root == "FREQ":
        return (lambda f: f), (lambda f: np.ones_like(np.asarray(f, float)))
    if root == "WAVN":
        return (lambda f: f / c), (lambda f: np.full_like(np.asarray(f, float), 1.0 / c))
    if root == "ENER":
        from ..units import h
        return (lambda f: f * h), (lambda f: np.full_like(np.asarray(f, float), h))
    if root == "WAVE":
        return (lambda f: c / f), (lambda f: -c / np.asarray(f, float) ** 2)
    if root == "AWAV":
        # needed to EVALUATE air-wavelength-sampled ctypes (XXXX-A2Y):
        # lambda_air = vac_to_air(c/f); d(lambda_air)/df via the Greisen
        # (2006) eq. 66 derivative of the vac<->air map
        def g(f):
            return vac_to_air(c / np.asarray(f, float))

        def d(f):
            fa = np.asarray(f, float)
            lam_air = vac_to_air(c / fa)
            return (-c / fa ** 2) / air_to_vac_deriv(lam_air)
        return g, d
    if rest_freq is None:
        raise ValueError("rest frequency required for velocity conversions")
    f0 = rest_freq
    if root == "VRAD":
        return ((lambda f: c * (f0 - f) / f0),
                (lambda f: np.full_like(np.asarray(f, float), -c / f0)))
    if root == "VOPT":
        return ((lambda f: c * (f0 - f) / f),
                (lambda f: -c * f0 / np.asarray(f, float) ** 2))
    if root == "VELO":
        def g(f):
            f = np.asarray(f, float)
            return c * (f0 ** 2 - f ** 2) / (f0 ** 2 + f ** 2)

        def d(f):
            f = np.asarray(f, float)
            return -4.0 * c * f0 ** 2 * f / (f0 ** 2 + f ** 2) ** 2
        return g, d
    raise ValueError(f"unknown spectral root {root!r}")


def spectral_value_transform(root_in: str, root_out: str, rest_freq):
    """(value, derivative) callables from root_in SI -> root_out SI."""
    f, df = _to_freq(root_in, rest_freq)
    g, dg = _from_freq(root_out, rest_freq)

    def val(x):
        return g(f(x))

    def deriv(x):
        return dg(f(x)) * df(x)

    return val, deriv


def _rest_freq_si(wcs: WCS, rest_value=None):
    if rest_value is not None:
        if isinstance(rest_value, Quantity):
            pt = rest_value.unit.physical_type
            if pt == "frequency":
                return float(rest_value.to_value("Hz"))
            if pt == "length":
                return c / float(rest_value.to_value("m"))
            raise UnitConversionError(
                "Rest value must be specified as an astropy quantity with "
                "spectral equivalence.")
        # bare numbers are ambiguous (Hz? m?) — the reference refuses them
        # (spectral_cube.py:1410-1413, test_invalid_rest)
        raise ValueError(
            "Rest value must be specified as an astropy quantity with "
            "spectral equivalence.")
    if wcs.restfrq:
        return wcs.restfrq
    if wcs.restwav:
        return c / wcs.restwav
    return None


def convert_spectral_axis(wcs: WCS, outunit, out_ctype: str,
                          rest_value=None) -> WCS:
    """Rewrite the spectral axis of ``wcs`` to ``outunit`` / ``out_ctype``.

    Equivalent in behavior to the reference ``convert_spectral_axis``
    (``spectral_axis.py:200-374``): new CRVAL is the exact converted value
    at the reference point, new CDELT is the analytic local derivative, and
    the CTYPE algorithm code preserves which variable is linearly sampled.
    """
    outunit = Unit.parse(outunit) if isinstance(outunit, str) else outunit
    i = wcs.spec
    if i < 0:
        raise ValueError("WCS has no spectral axis")
    inunit = wcs.cunit[i]
    in_ctype = wcs.ctype[i].strip().upper()
    in_root = in_ctype[:4]
    out_root = out_ctype.strip().upper()[:4]

    in_phys = inunit.physical_type
    out_phys = outunit.physical_type

    rest_freq = _rest_freq_si(wcs, rest_value)

    # speed -> speed with no rest value: the sampled variable cannot
    # change convention, but the unit scale must still be applied
    # (m/s -> km/s previously returned the WCS untouched, leaving the
    # axis a factor of 1000 off the requested unit)
    if in_phys == "speed" and out_phys == "speed" and rest_freq is None:
        if in_root != out_root:
            raise ValueError(
                "a rest frequency/wavelength is required to convert "
                f"between velocity conventions ({in_root} -> {out_root})")
        new = wcs.deepcopy()
        scale = inunit.scale / outunit.scale
        new.crval[i] = wcs.crval[i] * scale
        new.cdelt[i] = wcs.pixel_scale_matrix[i, i] * scale
        new.pc[i, i] = 1.0
        new.cunit[i] = outunit
        return new

    if rest_freq is None and (out_phys == "speed" or in_phys == "speed"):
        raise ValueError(
            "a rest frequency/wavelength is required to convert "
            "between speed and frequency/wavelength")

    # speed -> speed with BOTH a WCS-resident rest value and an explicit
    # new one: the input velocities are anchored to the WCS's OWN rest, so
    # re-anchor through the frequency frame (the reference recurses through
    # the linear frame first, spectral_axis.py:220-228).  The channel grid
    # — the underlying frequencies — stays fixed; only the velocity labels
    # change (reference test_change_rest_frequency pins this by checking
    # that any true frequency lands on the same pixel before and after).
    own_rest = _rest_freq_si(wcs, None)
    if (in_phys == "speed" and out_phys == "speed"
            and rest_value is not None and own_rest is not None
            and own_rest != rest_freq):
        val1, deriv1 = spectral_value_transform(in_root, "FREQ", own_rest)
        val2, deriv2 = spectral_value_transform("FREQ", out_root, rest_freq)

        def val(x, _v1=val1, _v2=val2):
            return _v2(_v1(x))

        def deriv(x, _v1=val1, _d1=deriv1, _d2=deriv2):
            return _d2(_v1(x)) * _d1(x)
    else:
        val, deriv = spectral_value_transform(in_root, out_root, rest_freq)

    crval_si = wcs.crval[i] * inunit.scale
    cdelt_si = wcs.pixel_scale_matrix[i, i] * inunit.scale
    crval_out = float(val(crval_si)) / outunit.scale
    cdelt_out = float(deriv(crval_si)) * cdelt_si / outunit.scale

    if cdelt_out == 0.0:
        raise ValueError("Conversion failed: the output CDELT would be 0.")

    new = wcs.deepcopy()
    new.crval[i] = crval_out
    new.cdelt[i] = cdelt_out
    new.pc[i, i] = 1.0
    new.cunit[i] = outunit
    new.ctype[i] = out_ctype
    if rest_value is not None:
        if isinstance(rest_value, Quantity) and \
                rest_value.unit.physical_type == "length":
            new.restwav = float(rest_value.to_value("m"))
            new.restfrq = 0.0
        else:
            new.restfrq = rest_freq
            new.restwav = 0.0
    elif rest_freq is not None and not (new.restfrq or new.restwav):
        new.restfrq = rest_freq
    return new


# air <-> vacuum wavelength (Griesen 2006 eq. 65-67)
def air_to_vac(wavelength_m):
    wlum = np.asarray(wavelength_m, float) * 1e6
    n = 1 + 1e-6 * (287.6155 + 1.62887 / wlum ** 2 + 0.01360 / wlum ** 4)
    return n * wavelength_m


def vac_to_air(wavelength_m):
    wlum = np.asarray(wavelength_m, float) * 1e6
    n = 1 + 1e-6 * (287.6155 + 1.62887 / wlum ** 2 + 0.01360 / wlum ** 4)
    return wavelength_m / n


def air_to_vac_deriv(wavelength_m):
    wlum = np.asarray(wavelength_m, float) * 1e6
    return 1 + 1e-6 * (287.6155 - 1.62887 / wlum ** 2 - 0.04080 / wlum ** 4)
