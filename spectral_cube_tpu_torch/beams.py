"""Gaussian beam algebra (standalone replacement for ``radio_beam``).

The reference imports ``radio_beam.Beam``/``Beams`` for all beam handling
(convolution kernels at ``spectral_cube/spectral_cube.py:3364-3392`` and
``:4180-4209``, per-channel beam tables, Jy/beam<->K factors).  radio_beam is
not a dependency here, so this module implements the required algebra from
the standard elliptical-Gaussian relations:

- beam solid angle, Jy/beam <-> K conversion factors,
- convolution / deconvolution of elliptical Gaussians (Wild 1970),
- common beam of a beam set,
- discrete convolution kernels (host-side numpy, fed to device FFT kernels).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import units as u
from .units import Quantity

__all__ = ["Beam", "Beams", "NoBeamError", "BeamError", "commonbeam"]

FWHM_TO_AREA = 2 * math.pi / (8 * math.log(2))  # per (fwhm_maj * fwhm_min)
SIGMA_TO_FWHM = math.sqrt(8 * math.log(2))


class NoBeamError(Exception):
    pass


class BeamError(ValueError):
    pass


class BeamUnitsError(BeamError):
    """Raised when an operation would silently invalidate Jy/beam units
    (reference utils.BeamUnitsError, base_class.py:116-140)."""


def _angle_value(x, default_unit="deg") -> float:
    """Return an angle in radians from a Quantity or bare number."""
    if isinstance(x, Quantity):
        return float(x.to_value("rad"))
    return float(Quantity(x, default_unit).to_value("rad"))


@dataclass(frozen=True, init=False)
class Beam:
    """An elliptical Gaussian beam: FWHM major/minor axes + position angle.

    Angles are stored in radians internally.  The constructor accepts the
    internal radian floats positionally, Quantities (any angle unit) in
    their place, or the radio_beam-style ``major=``/``minor=``/``pa=``
    keywords (reference usage at spectral_cube.py:3364-3392), so code
    written against radio_beam's ``Beam(major=1*u.deg, ...)`` works
    unchanged.
    """

    major_rad: float
    minor_rad: float
    pa_rad: float = 0.0

    def __init__(self, major_rad=None, minor_rad=None, pa_rad=None, *,
                 major=None, minor=None, pa=None):
        if major is not None:
            major_rad = major
        if minor is not None:
            minor_rad = minor
        if pa is not None:
            pa_rad = pa
        if major_rad is None:
            raise TypeError("Beam requires a major axis")

        def to_rad(v):
            # bare floats are the internal radian representation;
            # Quantities carry their own angle unit
            if isinstance(v, Quantity):
                return float(v.to_value("rad"))
            return float(v)

        maj = to_rad(major_rad)
        mnr = to_rad(minor_rad) if minor_rad is not None else maj
        object.__setattr__(self, "major_rad", maj)
        object.__setattr__(self, "minor_rad", mnr)
        object.__setattr__(self, "pa_rad",
                           to_rad(pa_rad) if pa_rad is not None else 0.0)
        # radio_beam parity: .major/.minor/.pa present in the unit the
        # beam was constructed with (a BEAMS-table beam reads back in
        # arcsec, a header beam in deg) and round-trip the ORIGINAL float
        # exactly — a deg->rad->deg trip is 1-2 ulp lossy, which breaks
        # the reference's exact header checks (test_append_beam_to_hdr)
        object.__setattr__(self, "_major_q",
                           major_rad if isinstance(major_rad, Quantity)
                           else None)
        object.__setattr__(self, "_minor_q",
                           minor_rad if isinstance(minor_rad, Quantity)
                           else (major_rad if minor_rad is None
                                 and isinstance(major_rad, Quantity)
                                 else None))
        object.__setattr__(self, "_pa_q",
                           pa_rad if isinstance(pa_rad, Quantity) else None)

    # -- constructors --------------------------------------------------------
    @staticmethod
    def make(major, minor=None, pa=None) -> "Beam":
        maj = _angle_value(major)
        mnr = _angle_value(minor) if minor is not None else maj
        pa_ = _angle_value(pa) if pa is not None else 0.0
        if mnr > maj * (1 + 1e-12) + 1e-30:
            raise BeamError("minor axis exceeds major axis")
        # pass the originals through so Quantity inputs keep their unit
        # and exact float value for presentation (.major etc.)
        return Beam(major if isinstance(major, Quantity) else maj,
                    (minor if isinstance(minor, Quantity) else mnr)
                    if minor is not None else maj,
                    (pa if isinstance(pa, Quantity) else pa_)
                    if pa is not None else 0.0)

    @staticmethod
    def from_header(header) -> "Beam | None":
        """BMAJ/BMIN/BPA in degrees (FITS convention), or None if absent."""
        if "BMAJ" not in header:
            return None
        bmaj = float(header["BMAJ"])
        bmin = float(header.get("BMIN", bmaj))
        bpa = float(header.get("BPA", 0.0))
        return Beam.make(Quantity(bmaj, "deg"), Quantity(bmin, "deg"),
                         Quantity(bpa, "deg"))

    @staticmethod
    def from_fits_keywords(**kw):
        return Beam.from_header(kw)

    @classmethod
    def from_fits_header(cls, header) -> "Beam | None":
        """radio_beam parity: accept a header object, a mapping, or a path
        to a FITS file (reference test_spectral_cube.py:1545-1551 passes
        the filename)."""
        if isinstance(header, (str, bytes)):
            from .io.fits_low import read_fits
            hdus = read_fits(header)
            header = hdus[0].header
        return cls.from_header(header)

    # -- properties -----------------------------------------------------------
    @property
    def major(self) -> Quantity:
        if self._major_q is not None:
            return self._major_q
        return Quantity(self.major_rad, "rad").to("deg")

    @property
    def minor(self) -> Quantity:
        if self._minor_q is not None:
            return self._minor_q
        return Quantity(self.minor_rad, "rad").to("deg")

    @property
    def pa(self) -> Quantity:
        if self._pa_q is not None:
            return self._pa_q
        return Quantity(self.pa_rad, "rad").to("deg")

    @property
    def sr(self) -> Quantity:
        """Beam solid angle: pi/(4 ln 2) * fwhm_maj * fwhm_min."""
        return Quantity(FWHM_TO_AREA * self.major_rad * self.minor_rad, "sr")

    @property
    def isfinite(self) -> bool:
        return (np.isfinite(self.major_rad) and np.isfinite(self.minor_rad)
                and np.isfinite(self.pa_rad) and self.major_rad > 0
                and self.minor_rad > 0)

    def __eq__(self, other):
        if not isinstance(other, Beam):
            return NotImplemented
        if not (self.isfinite and other.isfinite):
            return self.isfinite == other.isfinite
        circ = self.major_rad - self.minor_rad < 1e-12 * self.major_rad
        pa_match = circ or (
            abs((self.pa_rad - other.pa_rad + np.pi / 2) % np.pi - np.pi / 2)
            < 1e-8)
        return (math.isclose(self.major_rad, other.major_rad, rel_tol=1e-10)
                and math.isclose(self.minor_rad, other.minor_rad,
                                 rel_tol=1e-10)
                and pa_match)

    def __hash__(self):
        return hash((round(self.major_rad, 18), round(self.minor_rad, 18)))

    # -- algebra (Wild 1970 elliptical Gaussian convolution) ------------------
    def _abc(self):
        """Second-moment representation (alpha, beta, gamma) in rad^2."""
        maj2, min2 = self.major_rad ** 2, self.minor_rad ** 2
        c, s = math.cos(self.pa_rad), math.sin(self.pa_rad)
        alpha = maj2 * s * s + min2 * c * c
        beta = maj2 * c * c + min2 * s * s
        gamma = (maj2 - min2) * 2 * s * c
        return alpha, beta, gamma

    @staticmethod
    def _from_abc(alpha, beta, gamma) -> "Beam":
        s = alpha + beta
        t = math.sqrt((alpha - beta) ** 2 + gamma ** 2)
        maj = math.sqrt(0.5 * (s + t))
        mnr = math.sqrt(max(0.5 * (s - t), 0.0))
        if abs(gamma) + abs(alpha - beta) == 0:
            pa = 0.0
        else:
            # inverse of _abc's east-of-north convention:
            # alpha - beta = -(maj^2 - min^2) cos(2 pa),
            # gamma = (maj^2 - min^2) sin(2 pa)
            # => pa = atan2(gamma, beta - alpha) / 2.  (atan2(gamma,
            # alpha - beta) returns the complement 90 - pa: the output
            # convention then disagrees with the input's and
            # convolve -> deconvolve round-trips distort the axes.)
            pa = 0.5 * math.atan2(gamma, beta - alpha)
        return Beam(maj, mnr, pa)

    def convolve(self, other: "Beam") -> "Beam":
        a1, b1, g1 = self._abc()
        a2, b2, g2 = other._abc()
        return Beam._from_abc(a1 + a2, b1 + b2, g1 + g2)

    def deconvolve(self, other: "Beam", failure_returns_pointlike=False
                   ) -> "Beam":
        """Beam such that other * result == self; raises if impossible."""
        a1, b1, g1 = self._abc()
        a2, b2, g2 = other._abc()
        alpha, beta, gamma = a1 - a2, b1 - b2, g1 - g2
        s = alpha + beta
        t = math.sqrt((alpha - beta) ** 2 + gamma ** 2)
        # tolerance scaled to the beams involved
        limit = 1e-7 * (self.minor_rad ** 2 + other.minor_rad ** 2)
        if s < t and s >= t - limit * 2:
            # numerically point-like
            return Beam(0.0, 0.0, 0.0)
        if alpha < -limit or beta < -limit or s < t - limit:
            if failure_returns_pointlike:
                return Beam(0.0, 0.0, 0.0)
            raise BeamError(
                f"Beam {other} cannot be deconvolved from {self}")
        return Beam._from_abc(max(alpha, 0.0), max(beta, 0.0), gamma)

    def __mul__(self, other):
        if isinstance(other, Beam):
            return self.convolve(other)
        return NotImplemented

    # -- unit coupling ---------------------------------------------------------
    def jtok(self, freq) -> Quantity:
        """K per (Jy/beam) at frequency ``freq`` (Rayleigh-Jeans)."""
        nu = freq.to_value("Hz", equivalencies=u.spectral()) \
            if isinstance(freq, Quantity) else float(freq)
        factor = u.c ** 2 * 1e-26 / (2.0 * u.k_B * nu ** 2
                                     * float(self.sr.value))
        return Quantity(factor, "K")

    def jtok_equiv(self, freq):
        return u.brightness_temperature(self.sr, freq)

    # -- kernels -----------------------------------------------------------------
    def as_kernel(self, pixscale, x_size=None, y_size=None) -> np.ndarray:
        """Discrete elliptical-Gaussian kernel sampled at pixel centers,
        normalized to sum 1 (the host-side analog of
        ``radio_beam.Beam.as_kernel`` -> astropy Gaussian2DKernel used at
        reference spectral_cube.py:3372).

        ``pixscale``: angular size of a pixel (Quantity) or radians.
        """
        pix = pixscale.to_value("rad") if isinstance(pixscale, Quantity) \
            else float(pixscale)
        maj_pix = self.major_rad / pix / SIGMA_TO_FWHM
        min_pix = self.minor_rad / pix / SIGMA_TO_FWHM
        if x_size is None:
            # default support: 8 sigma of the major axis, odd size
            size = int(8 * max(maj_pix, 1e-3) + 1) | 1
            x_size = y_size = size
        if y_size is None:
            y_size = x_size
        y, x = np.mgrid[0:y_size, 0:x_size].astype(float)
        x -= (x_size - 1) / 2.0
        y -= (y_size - 1) / 2.0
        # pa measured counterclockwise from +y (North) toward +x=-RA (East);
        # in pixel coords with x=lon(increasing left), standard rotation:
        cpa, spa = math.cos(self.pa_rad + np.pi / 2), math.sin(
            self.pa_rad + np.pi / 2)
        xr = x * cpa + y * spa
        yr = -x * spa + y * cpa
        g = np.exp(-0.5 * ((xr / max(maj_pix, 1e-12)) ** 2 +
                           (yr / max(min_pix, 1e-12)) ** 2))
        ssum = g.sum()
        if ssum == 0:
            g[(y_size - 1) // 2, (x_size - 1) // 2] = 1.0
            ssum = 1.0
        return g / ssum

    def as_tophat_kernel(self, pixscale) -> np.ndarray:
        pix = pixscale.to_value("rad") if isinstance(pixscale, Quantity) \
            else float(pixscale)
        r_pix = self.major_rad / pix / 2.0
        size = int(2 * r_pix + 1) | 1
        y, x = np.mgrid[0:size, 0:size].astype(float) - (size - 1) / 2.0
        g = ((x ** 2 + y ** 2) <= r_pix ** 2).astype(float)
        return g / g.sum()

    def gaussian_transfer(self, fy, fx) -> np.ndarray:
        """Analytic Fourier transfer function of this beam on frequency grids
        (cycles/pixel-scaled already to radians): exp(-2 pi^2 sigma^2 f^2)
        along rotated axes.  Used by the fast FFT convolution path."""
        smaj = self.major_rad / SIGMA_TO_FWHM
        smin = self.minor_rad / SIGMA_TO_FWHM
        cpa, spa = math.cos(self.pa_rad + np.pi / 2), math.sin(
            self.pa_rad + np.pi / 2)
        fu = fx * cpa + fy * spa
        fv = -fx * spa + fy * cpa
        return np.exp(-2 * np.pi ** 2 * ((smaj * fu) ** 2 + (smin * fv) ** 2))

    def to_header_keywords(self) -> dict:
        return {"BMAJ": float(self.major.to_value("deg")),
                "BMIN": float(self.minor.to_value("deg")),
                "BPA": float(self.pa.to_value("deg"))}

    def __repr__(self):
        return (f"Beam: BMAJ={self.major.to_value('deg') * 3600:.4g} arcsec "
                f"BMIN={self.minor.to_value('deg') * 3600:.4g} arcsec "
                f"BPA={self.pa.to_value('deg'):.4g} deg")


class Beams:
    """A per-channel collection of beams (replacement for radio_beam.Beams)."""

    def __init__(self, major=None, minor=None, pa=None, beams=None):
        if beams is not None:
            self._beams = list(beams)
        else:
            # keep each input's unit so element beams present in it
            # (radio_beam parity: a BEAMS-table beam reads back in arcsec)
            maj_unit = str(major.unit) if isinstance(major, Quantity) \
                else "deg"
            # bare floats mean DEGREES regardless of the major's unit
            # (the pre-existing contract; inheriting maj_unit silently
            # rescaled a float minor next to an arcsec-Quantity major);
            # an OMITTED minor copies the major's values AND unit
            min_unit = str(minor.unit) if isinstance(minor, Quantity) \
                else ("deg" if minor is not None else maj_unit)
            pa_unit = str(pa.unit) if isinstance(pa, Quantity) else "deg"
            major = np.atleast_1d(np.asarray(
                major.value if isinstance(major, Quantity)
                else major, dtype=float))
            n = len(major)
            minor_v = np.atleast_1d(np.asarray(
                minor.value if isinstance(minor, Quantity)
                else (minor if minor is not None else major), dtype=float))
            pa_v = np.atleast_1d(np.asarray(
                pa.value if isinstance(pa, Quantity)
                else (pa if pa is not None else np.zeros(n)), dtype=float))
            # broadcast scalar minor/pa against a vector major like
            # radio_beam (a bare zip truncated the list to length 1)
            major, minor_v, pa_v = np.broadcast_arrays(major, minor_v,
                                                       pa_v)
            self._beams = [
                Beam(Quantity(m, maj_unit), Quantity(mn, min_unit),
                     Quantity(p, pa_unit))
                for m, mn, p in zip(major, minor_v, pa_v)]

    def __len__(self):
        return len(self._beams)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self._beams[item]
        if isinstance(item, slice):
            return Beams(beams=self._beams[item])
        item = np.asarray(item)
        if item.dtype == bool:
            return Beams(beams=[b for b, k in zip(self._beams, item) if k])
        return Beams(beams=[self._beams[i] for i in item])

    def __iter__(self):
        return iter(self._beams)

    def __eq__(self, other):
        if isinstance(other, Beams):
            return (len(self) == len(other)
                    and all(a == b for a, b in zip(self, other)))
        return NotImplemented

    @property
    def major(self) -> Quantity:
        return Quantity(np.array([b.major.to_value("deg")
                                  for b in self._beams]), "deg")

    @property
    def minor(self) -> Quantity:
        return Quantity(np.array([b.minor.to_value("deg")
                                  for b in self._beams]), "deg")

    @property
    def pa(self) -> Quantity:
        return Quantity(np.array([b.pa.to_value("deg")
                                  for b in self._beams]), "deg")

    @property
    def sr(self) -> Quantity:
        return Quantity(np.array([b.sr.value for b in self._beams]), "sr")

    @property
    def isfinite(self) -> np.ndarray:
        return np.array([b.isfinite for b in self._beams])

    def common_beam(self, tolerance: float = 1e-5, epsilon: float = 5e-4
                    ) -> Beam:
        return commonbeam(self, tolerance=tolerance, epsilon=epsilon)

    def largest_beam(self, include_mask=None) -> Beam:
        beams = self._masked(include_mask)
        return max(beams, key=lambda b: b.sr.value)

    def smallest_beam(self, include_mask=None) -> Beam:
        beams = self._masked(include_mask)
        return min(beams, key=lambda b: b.sr.value)

    def _masked(self, include_mask):
        if include_mask is None:
            return [b for b in self._beams if b.isfinite]
        return [b for b, k in zip(self._beams, include_mask)
                if k and b.isfinite]

    def extrema_beams(self, include_mask=None):
        return [self.smallest_beam(include_mask),
                self.largest_beam(include_mask)]

    def average_beam(self, include_mask=None) -> Beam:
        beams = self._masked(include_mask)
        maj = float(np.mean([b.major_rad for b in beams]))
        mnr = float(np.mean([b.minor_rad for b in beams]))
        # circular mean of 2*pa
        s = np.mean([math.sin(2 * b.pa_rad) for b in beams])
        c = np.mean([math.cos(2 * b.pa_rad) for b in beams])
        return Beam(maj, mnr, 0.5 * math.atan2(s, c))

    def to_table_columns(self):
        """Column dict for the FITS BEAMS bintable (arcsec/deg units)."""
        from collections import OrderedDict
        return OrderedDict(
            BMAJ=np.array([b.major.to_value("deg") * 3600
                           for b in self._beams], dtype="f4"),
            BMIN=np.array([b.minor.to_value("deg") * 3600
                           for b in self._beams], dtype="f4"),
            BPA=np.array([b.pa.to_value("deg") for b in self._beams],
                         dtype="f4"),
            CHAN=np.arange(len(self._beams), dtype="i4"),
            POL=np.zeros(len(self._beams), dtype="i4"),
        )

    def __repr__(self):
        return f"<Beams n={len(self)} major={self.major.value} deg>"


def beams_to_bintable(beams, pols=None):
    """Build a FITS BEAMS BinTableHDU from a Beams collection or a plain
    list of Beam (reference cube_utils.beams_to_bintable via radio_beam):
    BMAJ/BMIN in arcsec, BPA in deg, CHAN/POL columns, NCHAN set, NPOL = 0
    for a bare beam list or the number of distinct polarizations."""
    from .io.fits_low import BinTableHDU
    if not isinstance(beams, Beams):
        beams = Beams(beams=list(beams))
    cols = beams.to_table_columns()
    if pols is not None:
        cols["POL"] = np.asarray(pols, dtype="i4")
    bt = BinTableHDU(columns=cols, name="BEAMS",
                     units={"BMAJ": "arcsec", "BMIN": "arcsec", "BPA": "deg"})
    bt.header["NCHAN"] = len(beams)
    bt.header["NPOL"] = len(set(np.asarray(cols["POL"]).tolist())) \
        if pols is not None else 0
    return bt


def commonbeam(beams: Beams, tolerance: float = 1e-5, epsilon: float = 5e-4
               ) -> Beam:
    """Smallest beam from which every beam in the set can be deconvolved.

    Strategy: if the largest-area beam already contains all others, use it;
    otherwise numerically minimize the area of a containing ellipse
    (the approach CASA/radio_beam take, re-derived here as a direct
    constrained minimization with scipy).
    """
    finite = [b for b in beams if b.isfinite]
    if not finite:
        raise NoBeamError("no finite beams")
    if all(b == finite[0] for b in finite):
        return finite[0]

    largest = max(finite, key=lambda b: b.sr.value)
    if _contains_all(largest, finite):
        return largest

    from scipy.optimize import minimize

    scale = max(b.major_rad for b in finite)

    def unpack(x):
        # parameterize by second moments to keep positive-definiteness easy
        a, bb, g = x[0] * scale ** 2, x[1] * scale ** 2, x[2] * scale ** 2
        return a, bb, g

    def area(x):
        a, bb, g = unpack(x)
        det = a * bb - (g / 2) ** 2
        return det / scale ** 4  # monotone in area^2

    def constraints():
        cons = []
        for b in finite:
            ab, bbb, gb = b._abc()

            def c(x, ab=ab, bbb=bbb, gb=gb):
                a, bb, g = unpack(x)
                da, db, dg = a - ab, bb - bbb, g - gb
                s = da + db
                t = math.hypot(da - db, dg)
                return (s - t) / scale ** 2  # >= 0 iff deconvolvable
            cons.append({"type": "ineq", "fun": c})
        return cons

    l_a, l_b, l_g = largest._abc()
    x0 = np.array([l_a, l_b, l_g]) / scale ** 2 * (1 + 2 * epsilon)
    res = minimize(area, x0, constraints=constraints(), method="SLSQP",
                   options={"maxiter": 300, "ftol": tolerance ** 2})
    a, bb, g = unpack(res.x)
    cand = Beam._from_abc(a, bb, g)
    # inflate until strictly containing (guards optimizer tolerance)
    for _ in range(50):
        if _contains_all(cand, finite):
            return cand
        cand = Beam(cand.major_rad * (1 + epsilon),
                    cand.minor_rad * (1 + epsilon), cand.pa_rad)
    raise BeamError("common beam search failed to converge")


def _contains_all(beam: Beam, beams) -> bool:
    for b in beams:
        try:
            beam.deconvolve(b)
        except BeamError:
            return False
    return True
