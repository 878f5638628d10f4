"""Standalone unit system for spectral_cube_tpu.

The reference (radio-astro-tools/spectral-cube) leans on ``astropy.units`` for
its unit algebra (e.g. ``cube > 3*u.K``, BUNIT parsing at
``spectral_cube/cube_utils.py:478-507``, K<->Jy/beam conversion at
``cube_utils.py:572-749``).  astropy is not a dependency of this framework, so
we implement a small, fast, dependency-free unit system covering the unit
algebra a spectral-cube engine needs:

- dimensional analysis over SI base dimensions + angle + the radio
  pseudo-dimensions ``beam`` and ``pixel``;
- parsing of FITS BUNIT/CUNIT strings, including the common CASA/AIPS quirks
  the reference forgives (``JY/BEAM``, ``Kelvin``, ``km/s``, ``M/S``);
- equivalencies: spectral (freq<->wavelength<->wavenumber<->energy), doppler
  radio/optical/relativistic/z, brightness temperature, beam/pixel solid
  angle.

All values are stored host-side as plain Python floats / numpy arrays; the
device code only ever sees raw arrays plus pre-computed scale factors.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Unit",
    "Quantity",
    "UnitConversionError",
    "UnitsError",
    "parse_bunit",
    "spectral",
    "doppler_radio",
    "doppler_optical",
    "doppler_relativistic",
    "doppler_z",
    "doppler_beta",
    "doppler_gamma",
    "brightness_temperature",
    "beam_solid_angle",
    "pixel_scale",
    "c",
    "k_B",
    "h",
]

# ----------------------------------------------------------------------------
# physical constants (SI, CODATA 2018 — same values astropy.constants uses)
# ----------------------------------------------------------------------------
c = 299792458.0          # m / s
k_B = 1.380649e-23       # J / K
h = 6.62607015e-34       # J s


class UnitsError(ValueError):
    """Base class for unit-related errors (astropy u.UnitsError analog)."""


class UnitConversionError(UnitsError):
    """Raised when units cannot be converted into one another."""


# Dimension exponents: (kg, m, s, K, rad, beam, pix)
_NDIM = 7
_DIM_NAMES = ("kg", "m", "s", "K", "rad", "beam", "pix")
_ZERO = (0,) * _NDIM


def _dims(**kw) -> tuple:
    d = [0] * _NDIM
    for k, v in kw.items():
        d[_DIM_NAMES.index(k)] = v
    return tuple(d)


@dataclass(frozen=True)
class Unit:
    """A physical unit: an SI scale factor plus a dimension-exponent vector.

    ``scale`` is the size of this unit expressed in the SI base unit of its
    dimension (e.g. ``km`` has ``scale=1000``, ``Jy`` has ``scale=1e-26``).
    ``parts`` tracks the named atomic units this unit was composed from as
    ``((symbol, power), ...)`` so composite units render human-readably
    (``Jy km / (beam s)`` rather than a scaled-SI decomposition, matching
    what astropy shows users of the reference).  Equality and hashing
    ignore it: two units are the same physical unit regardless of spelling.
    """

    scale: float = 1.0
    dims: tuple = _ZERO
    name: str | None = None
    parts: tuple = ()

    def __post_init__(self):
        # astropy's ``u.Unit(...)`` is a factory that accepts a unit
        # string or an existing unit; users of the reference write
        # ``u.Unit("km/s")`` routinely, so the bare constructor must not
        # silently build a broken unit with ``scale="km/s"``.
        if isinstance(self.scale, (str, Unit)):
            src = self.scale if isinstance(self.scale, Unit) \
                else _parse_unit_string(self.scale)
            object.__setattr__(self, "scale", src.scale)
            object.__setattr__(self, "dims", src.dims)
            object.__setattr__(self, "name", src.name)
            object.__setattr__(self, "parts", src.parts)

    # -- part bookkeeping -----------------------------------------------------
    def _own_parts(self):
        """Parts dict for algebra, or None when untracked.

        A bare dimensionless scalar contributes nothing ({}); a unit with
        neither parts, name, nor zero dims is untracked (None) and poisons
        the composite so ``to_string`` falls back to the canonical form.
        """
        if self.parts:
            return dict(self.parts)
        if self.name:
            if not any(c in self.name for c in " /*.()^"):
                return {self.name: 1}
            try:  # compound name ("km / s"): recover parts by re-parsing
                p = _parse_unit_string(self.name)
            except UnitConversionError:
                return None
            if p.dims == self.dims and math.isclose(p.scale, self.scale,
                                                    rel_tol=1e-12):
                return dict(p.parts) if p.parts else None
            return None
        if self.dims == _ZERO:
            return {}
        return None

    @staticmethod
    def _merge_parts(pa, pb, sign=1):
        if pa is None or pb is None:
            return ()
        out = dict(pa)
        for k, v in pb.items():
            out[k] = out.get(k, 0) + sign * v
        return tuple(sorted((k, v) for k, v in out.items() if v != 0))

    # -- algebra ------------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Unit):
            name = None
            if other.name and self.dims == _ZERO and self.scale == 1.0:
                name = other.name
            elif self.name and other.dims == _ZERO and other.scale == 1.0:
                name = self.name
            return Unit(self.scale * other.scale,
                        tuple(a + b for a, b in zip(self.dims, other.dims)),
                        name=name,
                        parts=self._merge_parts(self._own_parts(),
                                                other._own_parts()))
        if isinstance(other, (int, float)):
            return Quantity(other, self)
        if isinstance(other, np.ndarray):
            return Quantity(other, self)
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, (int, float, np.ndarray)):
            return Quantity(other, self)
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale / other.scale,
                        tuple(a - b for a, b in zip(self.dims, other.dims)),
                        parts=self._merge_parts(self._own_parts(),
                                                other._own_parts(), sign=-1))
        if isinstance(other, (int, float)):
            return Unit(self.scale / other, self.dims,
                        parts=self._merge_parts(self._own_parts(), {}))
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, (int, float)):
            return Unit(other / self.scale, tuple(-d for d in self.dims),
                        parts=self._merge_parts({}, self._own_parts(),
                                                sign=-1))
        return NotImplemented

    def __pow__(self, p):
        if p == 0:
            return dimensionless
        scale = self.scale ** p
        dims = tuple(d * p for d in self.dims)
        if any(abs(d - round(d)) > 1e-9 for d in dims):
            raise UnitConversionError(f"non-integer dimension from {self}**{p}")
        own = self._own_parts()
        if own is None:
            parts = ()
        else:
            pp = {k: v * p for k, v in own.items()}
            parts = tuple(sorted(
                (k, int(round(v)) if abs(v - round(v)) < 1e-12 else v)
                for k, v in pp.items() if v != 0))
        return Unit(scale, tuple(int(round(d)) for d in dims), parts=parts)

    def __eq__(self, other):
        if isinstance(other, str):
            try:
                other = Unit.parse(other)
            except UnitConversionError:
                return False
        if not isinstance(other, Unit):
            return NotImplemented
        return (self.dims == other.dims
                and math.isclose(self.scale, other.scale, rel_tol=1e-12))

    def __hash__(self):
        return hash((round(math.log(self.scale) if self.scale > 0 else 0, 9),
                     self.dims))

    # -- queries ------------------------------------------------------------
    def is_equivalent(self, other, equivalencies: Sequence = ()) -> bool:
        other = Unit.parse(other) if isinstance(other, str) else other
        if self.dims == other.dims:
            return True
        # mirror Unit.to()'s multi-hop chaining (<= 3 equivalency hops)
        # so is_equivalent never disagrees with what to() can convert
        edges = []
        for dims_a, dims_b, _, _ in equivalencies:
            edges.append((dims_a, dims_b))
            edges.append((dims_b, dims_a))
        frontier = {self.dims}
        seen = {self.dims}
        for _ in range(3):
            nxt = set()
            for dims in frontier:
                for da, db in edges:
                    if dims == da and db not in seen:
                        if db == other.dims:
                            return True
                        seen.add(db)
                        nxt.add(db)
            frontier = nxt
        return False

    @property
    def physical_type(self) -> str:
        return _PHYSICAL_TYPES.get(self.dims, "unknown")

    @property
    def dimensionless(self) -> bool:
        return self.dims == _ZERO

    # -- conversion ----------------------------------------------------------
    def to(self, other, value=1.0, equivalencies: Sequence = ()):
        """Convert ``value`` in this unit to ``other``.

        Returns a float/array.  With no ``value`` argument this returns the
        multiplicative conversion factor (only valid for linear conversions).
        """
        other = Unit.parse(other) if isinstance(other, str) else other
        if self.dims == other.dims:
            return value * (self.scale / other.scale)
        for dims_a, dims_b, fwd, bwd in equivalencies:
            if self.dims == dims_a and other.dims == dims_b:
                si = value * self.scale
                return fwd(si) / other.scale
            if self.dims == dims_b and other.dims == dims_a:
                si = value * self.scale
                return bwd(si) / other.scale
        # multi-hop: chain up to three equivalencies (astropy composes
        # equivalency graphs the same way; needed for e.g. Jy/pix -> K,
        # which routes pix->sr (pixel_scale) then sr->K (brightness
        # temperature)).  BFS over the dims graph, shortest chain wins.
        edges = []
        for dims_a, dims_b, fwd, bwd in equivalencies:
            edges.append((dims_a, dims_b, fwd))
            edges.append((dims_b, dims_a, bwd))
        frontier = [(self.dims, ())]
        seen = {self.dims}
        for _ in range(3):
            nxt = []
            for dims, chain in frontier:
                for da, db, fn in edges:
                    if dims == da and db not in seen:
                        new_chain = chain + (fn,)
                        if db == other.dims:
                            x = value * self.scale
                            for f in new_chain:
                                x = f(x)
                            return x / other.scale
                        seen.add(db)
                        nxt.append((db, new_chain))
            frontier = nxt
        raise UnitConversionError(
            f"'{self}' and '{other}' are not convertible")

    def conversion_factor(self, other) -> float:
        """Pure multiplicative factor (raises if a nonlinear equivalency is needed)."""
        other = Unit.parse(other) if isinstance(other, str) else other
        if self.dims != other.dims:
            raise UnitConversionError(
                f"'{self}' and '{other}' are not convertible")
        return self.scale / other.scale

    # -- representation ------------------------------------------------------
    def to_string(self) -> str:
        if self.name:
            return self.name
        if self.parts:
            rendered = self._parts_string()
            if rendered is not None:
                return rendered
        # canonical form: scale kg^a m^b ...
        parts = []
        for n, d in zip(_DIM_NAMES, self.dims):
            if d == 1:
                parts.append(n)
            elif d != 0:
                parts.append(f"{n}{d}")
        body = " ".join(parts) if parts else ""
        if math.isclose(self.scale, 1.0, rel_tol=1e-12):
            return body or ""
        # full repr precision: to_string/parse must round-trip exactly
        # (headers write BUNIT from to_string and reparse it)
        return f"{self.scale!r} {body}".strip()

    def _parts_string(self):
        """Astropy-style render from the tracked atomic parts, e.g.
        ``Jy km / (beam s)``; any scale not accounted for by the parts is
        emitted as a leading repr-precision factor so to_string/parse
        round-trips exactly.  Returns None if a part is not resolvable."""
        residual = self.scale
        try:
            for n, p in self.parts:
                residual /= _lookup_symbol(n).scale ** p
        except UnitConversionError:
            return None

        def fmt(n, p):
            return n if p == 1 else f"{n}{p:g}"

        num = [(n, p) for n, p in self.parts if p > 0]
        den = [(n, -p) for n, p in self.parts if p < 0]
        num_s = " ".join(fmt(n, p) for n, p in num)
        if den:
            den_s = " ".join(fmt(n, p) for n, p in den)
            if len(den) > 1:
                den_s = f"({den_s})"
            body = f"{num_s or '1'} / {den_s}"
        else:
            body = num_s
        if not math.isclose(residual, 1.0, rel_tol=1e-12):
            body = f"{residual!r} {body}".strip()
        return body

    def __repr__(self):
        return f"Unit('{self.to_string()}')"

    def __str__(self):
        return self.to_string()

    # -- parsing ---------------------------------------------------------------
    @staticmethod
    def parse(s: "str | Unit") -> "Unit":
        if isinstance(s, Unit):
            return s
        return _parse_unit_string(s)


def _named(name: str, scale: float, dims: tuple) -> Unit:
    return Unit(scale, dims, name=name,
                parts=((name, 1),) if name else ())


dimensionless = _named("", 1.0, _ZERO)

# base + derived units -------------------------------------------------------
_BASE_UNITS: dict[str, Unit] = {}


def _register(names: Iterable[str], unit: Unit):
    for n in names:
        _BASE_UNITS[n] = unit


_register(["kg"], _named("kg", 1.0, _dims(kg=1)))
_register(["g"], _named("g", 1e-3, _dims(kg=1)))
_register(["m", "meter", "meters", "metres"], _named("m", 1.0, _dims(m=1)))
_register(["s", "sec", "second", "seconds"], _named("s", 1.0, _dims(s=1)))
_register(["K", "Kelvin", "kelvin", "KELVIN"], _named("K", 1.0, _dims(K=1)))
_register(["rad", "radian", "radians"], _named("rad", 1.0, _dims(rad=1)))
_register(["deg", "degree", "degrees", "DEG", "DEGREE", "DEGREES"],
          _named("deg", math.pi / 180.0, _dims(rad=1)))
_register(["arcmin"], _named("arcmin", math.pi / 180.0 / 60.0, _dims(rad=1)))
_register(["arcsec"], _named("arcsec", math.pi / 180.0 / 3600.0, _dims(rad=1)))
_register(["mas"], _named("mas", math.pi / 180.0 / 3600.0e3, _dims(rad=1)))
_register(["sr", "steradian"], _named("sr", 1.0, _dims(rad=2)))
_register(["beam", "BEAM", "Beam", "beams"], _named("beam", 1.0, _dims(beam=1)))
_register(["pix", "pixel", "pixels", "PIXEL", "PIX"],
          _named("pix", 1.0, _dims(pix=1)))
_register(["Hz", "hz", "HZ", "hertz"], _named("Hz", 1.0, _dims(s=-1)))
_register(["Jy", "JY", "jy", "jansky", "Jansky"],
          _named("Jy", 1e-26, _dims(kg=1, s=-2)))
_register(["W", "watt"], _named("W", 1.0, _dims(kg=1, m=2, s=-3)))
_register(["J", "joule"], _named("J", 1.0, _dims(kg=1, m=2, s=-2)))
_register(["eV"], _named("eV", 1.602176634e-19, _dims(kg=1, m=2, s=-2)))
_register(["erg"], _named("erg", 1e-7, _dims(kg=1, m=2, s=-2)))
_register(["Angstrom", "angstrom", "AA", "A"],
          _named("Angstrom", 1e-10, _dims(m=1)))
_register(["um", "micron"], _named("um", 1e-6, _dims(m=1)))
_register(["ct", "count", "counts", "COUNT", "COUNTS"],
          _named("ct", 1.0, _ZERO))
_register(["adu", "ADU"], _named("adu", 1.0, _ZERO))

_SI_PREFIXES = {
    "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15, "p": 1e-12, "n": 1e-9,
    "u": 1e-6, "µ": 1e-6, "m": 1e-3, "c": 1e-2, "d": 1e-1, "da": 1e1,
    "h": 1e2, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
}

# physical types used by the spectral-axis machinery
_PHYSICAL_TYPES = {
    _dims(s=-1): "frequency",
    _dims(m=1): "length",
    _dims(m=1, s=-1): "speed",
    _dims(K=1): "temperature",
    _dims(kg=1, s=-2): "spectral flux density",
    _dims(kg=1, m=2, s=-2): "energy",
    _dims(m=-1): "wavenumber",
    _dims(rad=1): "angle",
    _dims(rad=2): "solid angle",
    _ZERO: "dimensionless",
}

_token_re = re.compile(r"\s*([A-Za-zµ]+|\*\*|[*/.()]|[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|\^)\s*")


def _lookup_symbol(sym: str) -> Unit:
    if sym in _BASE_UNITS:
        return _BASE_UNITS[sym]
    # case-forgiving lookup (FITS headers are frequently uppercased: JY/BEAM)
    for cand in (sym.lower(), sym.capitalize(), sym.upper()):
        if cand in _BASE_UNITS:
            return _BASE_UNITS[cand]
    # SI prefix + known unit.  In an ALL-CAPS symbol (AIPS/CASA headers)
    # a leading 'M'/'P'/'E'... is ambiguous — "MJY" could be mega- or a
    # shouted milli-Jy — so, like astropy, refuse those; prefixes whose
    # lowercase twin is not a different prefix (K->k, D->d, C->c...)
    # fold safely.
    ambiguous_caps = set("MPEGTZY")
    if sym.isupper() and len(sym) > 1 and sym[0] in ambiguous_caps:
        raise UnitConversionError(
            f"Unknown unit symbol: {sym!r} (all-caps prefixed units with "
            f"'{sym[0]}' are ambiguous: mega- vs milli- etc.)")
    for plen in (2, 1):
        if len(sym) > plen and sym[:plen] in _SI_PREFIXES:
            rest = sym[plen:]
            if rest in _BASE_UNITS:
                base = _BASE_UNITS[rest]
                nm = sym[:plen] + (base.name or rest)
                return Unit(base.scale * _SI_PREFIXES[sym[:plen]], base.dims,
                            name=nm, parts=((nm, 1),))
            for cand in (rest.lower(), rest.capitalize()):
                if cand in _BASE_UNITS:
                    base = _BASE_UNITS[cand]
                    nm = sym[:plen] + (base.name or cand)
                    return Unit(base.scale * _SI_PREFIXES[sym[:plen]],
                                base.dims, name=nm, parts=((nm, 1),))
    if sym.isupper() and len(sym) > 1:
        # unambiguous all-caps prefixed unit: KM/S etc. — refold fully
        try:
            return _lookup_symbol(sym.lower())
        except UnitConversionError:
            pass
    raise UnitConversionError(f"Unknown unit symbol: {sym!r}")


def _parse_unit_string(s: str) -> Unit:
    """Parse a FITS-style unit string.

    Handles '*', '/', '.', whitespace or juxtaposition as multiplication,
    integer exponents with or without '**'/'^', and parentheses, e.g.
    'Jy / beam', 'JY/BEAM', 'km s-1', 'K.km/s', 'W m^-2', 'erg/(s cm2)'.
    """
    s = s.strip()
    if s in ("", "1", "''"):
        return dimensionless

    tokens = []
    pos = 0
    while pos < len(s):
        mm = _token_re.match(s, pos)
        if not mm:
            raise UnitConversionError(f"Cannot parse unit string {s!r} at {pos}")
        tokens.append(mm.group(1))
        pos = mm.end()

    def parse_expr(i):
        unit, i = parse_term(i)
        while i < len(tokens):
            t = tokens[i]
            if t in ("*", "."):
                rhs, i = parse_term(i + 1)
                unit = unit * rhs
            elif t == "/":
                rhs, i = parse_term(i + 1)
                unit = unit / rhs
            elif t == ")":
                break
            else:  # juxtaposition: 'km s-1'
                rhs, i = parse_term(i)
                unit = unit * rhs
        return unit, i

    def parse_term(i):
        if i >= len(tokens):
            raise UnitConversionError(f"Unexpected end of unit string {s!r}")
        t = tokens[i]
        if t == "(":
            unit, i = parse_expr(i + 1)
            if i >= len(tokens) or tokens[i] != ")":
                raise UnitConversionError(f"Unbalanced parens in {s!r}")
            i += 1
        else:
            try:
                val = float(t)
                unit = Unit(val, _ZERO)
                i += 1
            except ValueError:
                unit = _lookup_symbol(t)
                i += 1
        # optional exponent
        if i < len(tokens) and tokens[i] in ("**", "^"):
            i += 1
            if i >= len(tokens):
                raise UnitConversionError(f"Missing exponent in {s!r}")
            unit = unit ** float(tokens[i])
            i += 1
        elif i < len(tokens):
            try:
                exp = float(tokens[i])
                unit = unit ** exp
                i += 1
            except ValueError:
                pass
        return unit, i

    unit, i = parse_expr(0)
    if i != len(tokens):
        raise UnitConversionError(f"Trailing tokens in unit string {s!r}")
    if (isinstance(s, str) and " " not in s and unit.name is None
            and not unit.parts):
        return Unit(unit.scale, unit.dims, name=s)
    return unit


# ----------------------------------------------------------------------------
# Quantity
# ----------------------------------------------------------------------------
def parse_bunit(text):
    """Forgiving BUNIT parse for read paths: unparseable strings warn and
    return None (the reference's convert_bunit behavior,
    cube_utils.py:478-505) instead of refusing to load the file."""
    text = str(text).strip()
    if not text:
        return None
    try:
        return Unit.parse(text)
    except UnitConversionError:
        import warnings
        warnings.warn(f"Could not parse unit {text!r}")
        return None


class Quantity:
    """A value (scalar or numpy array) with a unit.

    Mirrors the slice of the astropy ``Quantity`` API the reference library's
    public surface uses: arithmetic, comparisons, ``.to()``, ``.value``,
    ``.unit``.  Device arrays should be unwrapped (``.value``) before use in
    jitted code.
    """

    __array_priority__ = 10000  # beat ndarray in mixed ops

    def __init__(self, value, unit: "Unit | str | None" = None):
        if isinstance(value, Quantity):
            # copy-construction: no unit given -> inherit (astropy
            # semantics; defaulting to dimensionless raised for any
            # dimensional quantity)
            unit0 = value.unit if unit is None else Unit.parse(unit)
            value = value.to_value(unit0)
            self.value = value
            self.unit = unit0
            return
        if unit is None:
            unit = dimensionless
        if np.isscalar(value) or hasattr(value, "dtype"):
            # keep device (jax) arrays as-is; only coerce plain sequences
            self.value = value
        else:
            self.value = np.asarray(value)
        self.unit = Unit.parse(unit)

    # conversion --------------------------------------------------------------
    def to(self, unit, equivalencies: Sequence = ()) -> "Quantity":
        unit = Unit.parse(unit)
        return Quantity(self.unit.to(unit, self.value, equivalencies), unit)

    def to_value(self, unit=None, equivalencies: Sequence = ()):
        if unit is None:
            return self.value
        return self.unit.to(Unit.parse(unit), self.value, equivalencies)

    def is_equivalent(self, other, equivalencies: Sequence = ()):
        return self.unit.is_equivalent(other, equivalencies)

    @property
    def si_value(self):
        return self.value * self.unit.scale

    # arithmetic ---------------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, Quantity):
            return other
        if isinstance(other, Unit):
            return Quantity(1.0, other)
        return Quantity(other, dimensionless)

    def __add__(self, other):
        o = self._coerce(other)
        return Quantity(self.value + o.to_value(self.unit), self.unit)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return Quantity(self.value - o.to_value(self.unit), self.unit)

    def __rsub__(self, other):
        o = self._coerce(other)
        return Quantity(o.to_value(self.unit) - self.value, self.unit)

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit * other)
        o = self._coerce(other)
        return Quantity(self.value * o.value, self.unit * o.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit / other)
        o = self._coerce(other)
        return Quantity(self.value / o.value, self.unit / o.unit)

    def __rtruediv__(self, other):
        o = self._coerce(other)
        return Quantity(o.value / self.value, o.unit / self.unit)

    def __pow__(self, p):
        return Quantity(self.value ** p, self.unit ** p)

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __abs__(self):
        return Quantity(abs(self.value), self.unit)

    # comparisons ---------------------------------------------------------------
    def _cmp_value(self, other):
        o = self._coerce(other)
        return o.to_value(self.unit)

    def __lt__(self, other):
        return self.value < self._cmp_value(other)

    def __le__(self, other):
        return self.value <= self._cmp_value(other)

    def __gt__(self, other):
        return self.value > self._cmp_value(other)

    def __ge__(self, other):
        return self.value >= self._cmp_value(other)

    def __eq__(self, other):
        try:
            return self.value == self._cmp_value(other)
        except UnitConversionError:
            return False

    def __ne__(self, other):
        eq = self.__eq__(other)
        if isinstance(eq, bool):
            return not eq
        return ~eq

    def __hash__(self):
        return hash((np.ndim(self.value) == 0 and float(self.value), self.unit))

    # array-ish ------------------------------------------------------------------
    def __len__(self):
        return len(self.value)

    def copy(self):
        """An independent copy (astropy Quantity.copy parity)."""
        return Quantity(np.array(self.value, copy=True), self.unit)

    def __getitem__(self, item):
        return Quantity(self.value[item], self.unit)

    def __iter__(self):
        for v in np.atleast_1d(self.value):
            yield Quantity(v, self.unit)

    def __array__(self, dtype=None):
        return np.asarray(self.value, dtype=dtype)

    # numpy ufunc protocol: keep units through np.abs(q), np.add(q, q),
    # np.sqrt(q), ... like astropy Quantity (the reference's
    # _apply_everywhere probes rely on exactly this,
    # spectral_cube.py:936-938)
    _UNIT_KEEPING_UFUNCS = {"absolute", "fabs", "negative", "positive",
                            "rint", "floor", "ceil", "trunc", "conjugate",
                            "minimum", "maximum", "fmin", "fmax",
                            "nan_to_num"}
    _UNIT_MATCHING_UFUNCS = {"add", "subtract", "hypot"}
    _BOOL_UFUNCS = {"isfinite", "isnan", "isinf", "signbit",
                    "greater", "greater_equal", "less", "less_equal",
                    "equal", "not_equal"}
    _DIMENSIONLESS_UFUNCS = {"exp", "exp2", "expm1", "log", "log2",
                             "log10", "log1p", "sin", "cos", "tan",
                             "arcsin", "arccos", "arctan", "sinh",
                             "cosh", "tanh", "arcsinh", "arccosh",
                             "arctanh"}

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if kwargs.get("out") is not None:
            return NotImplemented
        name = ufunc.__name__
        if method == "reduce":
            # np.min/max/sum/nanmin/nanmax(q) lower to <ufunc>.reduce;
            # without this branch numpy would raise instead of falling
            # back to __array__ once __array_ufunc__ exists
            arr = np.asarray(inputs[0])
            if name in ("minimum", "maximum", "fmin", "fmax", "add"):
                return Quantity(ufunc.reduce(arr, **kwargs), self.unit)
            if name in ("logical_or", "logical_and"):
                return ufunc.reduce(arr, **kwargs)
            return NotImplemented
        if method == "accumulate" and name == "add":
            return Quantity(ufunc.accumulate(np.asarray(inputs[0]),
                                             **kwargs), self.unit)
        if method != "__call__":
            return NotImplemented

        def val(x, unit=None):
            if isinstance(x, Quantity):
                return x.to_value(unit) if unit is not None else x.value
            if unit is not None and not unit.dimensionless:
                raise UnitConversionError(
                    f"np.{name} needs {unit} operand, got a bare value")
            return x

        if name in self._UNIT_KEEPING_UFUNCS and len(inputs) == 1:
            return Quantity(ufunc(val(inputs[0])), self.unit)
        if name in self._UNIT_KEEPING_UFUNCS and len(inputs) == 2:
            a, b = inputs
            return Quantity(ufunc(val(a, self.unit), val(b, self.unit)),
                            self.unit)
        if name in self._UNIT_MATCHING_UFUNCS:
            a, b = inputs
            return Quantity(ufunc(val(a, self.unit), val(b, self.unit)),
                            self.unit)
        if name in self._BOOL_UFUNCS:
            if len(inputs) == 1:
                return ufunc(val(inputs[0]))
            a, b = inputs
            try:
                return ufunc(val(a, self.unit), val(b, self.unit))
            except UnitConversionError:
                if name in ("equal", "not_equal"):
                    # match the == operator: incompatible units compare
                    # unequal instead of raising
                    shape = np.broadcast_shapes(np.shape(a), np.shape(b))
                    out = np.full(shape, name == "not_equal", dtype=bool)
                    return out if shape else bool(out)
                raise
        if name == "multiply":
            a, b = (x if isinstance(x, Quantity) else Quantity(x)
                    for x in inputs)
            return Quantity(ufunc(a.value, b.value), a.unit * b.unit)
        if name in ("divide", "true_divide"):
            a, b = (x if isinstance(x, Quantity) else Quantity(x)
                    for x in inputs)
            return Quantity(ufunc(a.value, b.value), a.unit / b.unit)
        if name == "sqrt":
            return Quantity(ufunc(val(inputs[0])), self.unit ** 0.5)
        if name == "square":
            return Quantity(ufunc(val(inputs[0])), self.unit ** 2)
        if name in ("power", "float_power"):
            a, p = inputs
            p = float(p)
            return Quantity(ufunc(val(a), p), self.unit ** p)
        if name in self._DIMENSIONLESS_UFUNCS:
            q = inputs[0]
            if isinstance(q, Quantity):
                if name in ("sin", "cos", "tan") and \
                        q.unit.dims == _dims(rad=1):
                    # trig of an angle Quantity: convert to radians
                    # (np.sin(Quantity(90, 'deg')) -> 1.0, like astropy)
                    v = q.to_value(Unit.parse("rad"))
                else:
                    v = q.to_value(Unit.parse(""))
            else:
                v = q
            return ufunc(v)
        return NotImplemented

    @property
    def shape(self):
        return np.shape(self.value)

    @property
    def ndim(self):
        return np.ndim(self.value)

    @property
    def size(self):
        return np.size(self.value)

    @property
    def dtype(self):
        return np.asarray(self.value).dtype

    def reshape(self, *shape):
        return Quantity(np.reshape(self.value, shape), self.unit)

    def __float__(self):
        return float(self.value)

    def item(self):
        return np.asarray(self.value).item()

    @staticmethod
    def _redkw(kwargs):
        """Keep only the reduction kwargs we forward (numpy's
        _wrapreduction passes out=None / where=True / initial=_NoValue
        defaults through to the method)."""
        out = {}
        kd = kwargs.get("keepdims")
        if kd is not None and kd is not np._NoValue:
            out["keepdims"] = kd
        return out

    def min(self, axis=None, **kwargs):
        return Quantity(np.min(np.asarray(self.value), axis=axis,
                               **self._redkw(kwargs)), self.unit)

    def max(self, axis=None, **kwargs):
        return Quantity(np.max(np.asarray(self.value), axis=axis,
                               **self._redkw(kwargs)), self.unit)

    def mean(self, axis=None, **kwargs):
        return Quantity(np.mean(np.asarray(self.value), axis=axis,
                                **self._redkw(kwargs)), self.unit)

    # the full reduction set the reference reroutes to bare Quantities
    # (lower_dimensional_structures.py:802-812)
    def std(self, axis=None, **kwargs):
        return Quantity(np.std(np.asarray(self.value), axis=axis,
                               **self._redkw(kwargs)), self.unit)

    def var(self, axis=None, **kwargs):
        return Quantity(np.var(np.asarray(self.value), axis=axis,
                               **self._redkw(kwargs)), self.unit ** 2)

    def sum(self, axis=None, **kwargs):
        return Quantity(np.sum(np.asarray(self.value), axis=axis,
                               **self._redkw(kwargs)), self.unit)

    def nansum(self, axis=None, **kwargs):
        return Quantity(np.nansum(np.asarray(self.value), axis=axis,
                                  **self._redkw(kwargs)), self.unit)

    def cumsum(self, axis=None, **kwargs):
        return Quantity(np.cumsum(np.asarray(self.value), axis=axis),
                        self.unit)

    def argmax(self, axis=None):
        # ndarray API: plain integer indices, no unit
        return np.argmax(np.asarray(self.value), axis=axis)

    def argmin(self, axis=None):
        return np.argmin(np.asarray(self.value), axis=axis)

    def ptp(self):
        return Quantity(np.ptp(np.asarray(self.value)), self.unit)

    def round(self, decimals=0):
        return Quantity(np.round(np.asarray(self.value), decimals),
                        self.unit)

    def squeeze(self):
        return Quantity(np.squeeze(self.value), self.unit)

    def __repr__(self):
        return f"<Quantity {self.value} {self.unit}>"


# ----------------------------------------------------------------------------
# Equivalencies
# ----------------------------------------------------------------------------
# Equivalencies are lists of (dims_a, dims_b, fwd(si)->si, bwd(si)->si).
_FREQ = _dims(s=-1)
_LEN = _dims(m=1)
_SPEED = _dims(m=1, s=-1)
_TEMP = _dims(K=1)
_WAVENUM = _dims(m=-1)
_ENERGY = _dims(kg=1, m=2, s=-2)


def spectral():
    """freq <-> wavelength <-> wavenumber <-> energy (vacuum)."""
    return [
        (_FREQ, _LEN, lambda nu: c / nu, lambda lam: c / lam),
        (_FREQ, _WAVENUM, lambda nu: nu / c, lambda k: k * c),
        (_FREQ, _ENERGY, lambda nu: h * nu, lambda E: E / h),
        (_LEN, _WAVENUM, lambda lam: 1.0 / lam, lambda k: 1.0 / k),
        (_LEN, _ENERGY, lambda lam: h * c / lam, lambda E: h * c / E),
    ]


def _rest_freq_si(rest_value) -> float:
    """Normalize a rest value (Quantity in Hz or m) to frequency in Hz."""
    if isinstance(rest_value, Quantity):
        if rest_value.unit.dims == _FREQ:
            return float(rest_value.si_value)
        if rest_value.unit.dims == _LEN:
            return c / float(rest_value.si_value)
        raise UnitConversionError("rest value must be frequency or length")
    return float(rest_value)


def doppler_radio(rest_value):
    """V_rad = c (nu0 - nu) / nu0 ;  freq<->speed and wave<->speed."""
    f0 = _rest_freq_si(rest_value)
    lam0 = c / f0
    return [
        (_FREQ, _SPEED,
         lambda nu: c * (f0 - nu) / f0,
         lambda v: f0 * (1.0 - v / c)),
        (_LEN, _SPEED,
         lambda lam: c * (lam - lam0) / lam,
         lambda v: lam0 / (1.0 - v / c)),
    ]


def doppler_optical(rest_value):
    """V_opt = c (lam - lam0) / lam0."""
    f0 = _rest_freq_si(rest_value)
    lam0 = c / f0
    return [
        (_FREQ, _SPEED,
         lambda nu: c * (f0 - nu) / nu,
         lambda v: f0 / (1.0 + v / c)),
        (_LEN, _SPEED,
         lambda lam: c * (lam - lam0) / lam0,
         lambda v: lam0 * (1.0 + v / c)),
    ]


def doppler_relativistic(rest_value):
    """V = c (f0^2 - f^2)/(f0^2 + f^2)."""
    f0 = _rest_freq_si(rest_value)
    lam0 = c / f0

    def f2v(nu):
        return c * (f0 ** 2 - nu ** 2) / (f0 ** 2 + nu ** 2)

    def v2f(v):
        b = v / c
        return f0 * np.sqrt((1.0 - b) / (1.0 + b))

    return [
        (_FREQ, _SPEED, f2v, v2f),
        (_LEN, _SPEED,
         lambda lam: f2v(c / lam),
         lambda v: c / v2f(v)),
    ]


def doppler_z(rest_value):
    """CASA 'Z' convention: z*c where z = (f0 - f)/f (dimensionally a speed)."""
    f0 = _rest_freq_si(rest_value)
    return [
        (_FREQ, _SPEED,
         lambda nu: c * (f0 - nu) / nu,
         lambda v: f0 / (1.0 + v / c)),
    ]


def doppler_beta(rest_value):
    """Relativistic beta convention v = c (f0^2-nu^2)/(f0^2+nu^2)
    (reference spectral_axis.py:181-188)."""
    f0 = _rest_freq_si(rest_value)

    def v2f(v):
        b = v / c
        return f0 * np.sqrt((1.0 - b) / (1.0 + b))

    return [
        (_FREQ, _SPEED,
         lambda nu: c * (f0 ** 2 - nu ** 2) / (f0 ** 2 + nu ** 2), v2f),
    ]


def doppler_gamma(rest_value):
    """Lorentz-gamma convention v = c (f0^2+nu^2)/(2 f0 nu)
    (reference spectral_axis.py:190-197)."""
    f0 = _rest_freq_si(rest_value)
    return [
        (_FREQ, _SPEED,
         lambda nu: c * (f0 ** 2 + nu ** 2) / (2.0 * f0 * nu),
         lambda v: f0 * (v / c + np.sqrt((v / c) ** 2 - 1.0))),
    ]


def brightness_temperature(beam_area, freq):
    """Jy/beam (or Jy/sr via beam_area=1 sr) <-> K at frequency ``freq``.

    Rayleigh-Jeans: T = S c^2 / (2 k_B nu^2 Omega).
    ``beam_area``: Quantity in sr (solid angle per beam).
    """
    nu = freq.to_value("Hz", equivalencies=spectral()) if isinstance(freq, Quantity) else float(freq)
    omega = beam_area.to_value("sr") if isinstance(beam_area, Quantity) else float(beam_area)
    factor = c ** 2 / (2.0 * k_B * nu ** 2 * omega)
    jy_per_beam = _dims(kg=1, s=-2, beam=-1)
    jy_per_sr = _dims(kg=1, s=-2, rad=-2)
    return [
        (jy_per_beam, _TEMP, lambda s: s * factor, lambda t: t / factor),
        (jy_per_sr, _TEMP,
         lambda s: s * omega * factor, lambda t: t / (omega * factor)),
        (_dims(kg=1, s=-2), _TEMP,  # plain Jy treated as per-beam flux
         lambda s: s * factor, lambda t: t / factor),
    ]


def beam_solid_angle(beam_area):
    """beam <-> sr given the beam solid angle."""
    omega = beam_area.to_value("sr") if isinstance(beam_area, Quantity) else float(beam_area)
    return [
        (_dims(beam=1), _dims(rad=2), lambda b: b * omega, lambda s: s / omega),
        (_dims(beam=-1, kg=1, s=-2), _dims(rad=-2, kg=1, s=-2),
         lambda x: x / omega, lambda x: x * omega),
    ]


def pixel_scale(pixel_area):
    """pix <-> sr given the pixel solid angle."""
    omega = pixel_area.to_value("sr") if isinstance(pixel_area, Quantity) else float(pixel_area)
    return [
        (_dims(pix=1), _dims(rad=2), lambda p: p * omega, lambda s: s / omega),
        (_dims(pix=-1, kg=1, s=-2), _dims(rad=-2, kg=1, s=-2),
         lambda x: x / omega, lambda x: x * omega),
    ]


# ----------------------------------------------------------------------------
# convenience module-level unit instances (u.K etc.)
# ----------------------------------------------------------------------------
def __getattr__(name):
    try:
        return _lookup_symbol(name)
    except UnitConversionError as exc:
        raise AttributeError(str(exc)) from exc


K = _BASE_UNITS["K"]
Jy = _BASE_UNITS["Jy"]
beam = _BASE_UNITS["beam"]
pix = _BASE_UNITS["pix"]
Hz = _BASE_UNITS["Hz"]
m = _BASE_UNITS["m"]
s_ = _BASE_UNITS["s"]
deg = _BASE_UNITS["deg"]
rad = _BASE_UNITS["rad"]
arcsec = _BASE_UNITS["arcsec"]
sr = _BASE_UNITS["sr"]
km = Unit(1000.0, _dims(m=1), name="km")
GHz = Unit(1e9, _dims(s=-1), name="GHz")
MHz = Unit(1e6, _dims(s=-1), name="MHz")
kHz = Unit(1e3, _dims(s=-1), name="kHz")
km_s = Unit(1000.0, _SPEED, name="km / s")
m_s = Unit(1.0, _SPEED, name="m / s")
mJy = Unit(1e-29, _dims(kg=1, s=-2), name="mJy")
