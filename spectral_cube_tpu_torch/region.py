"""Region-based subcube extraction (DS9 / CRTF region strings).

Port of ``spectral_cube_tpu/region.py``.  The reference library delegates
to the external ``regions`` package (``spectral_cube/spectral_cube.py:
2038-2235``); this module parses the common region shapes itself
(circle, ellipse, box / rotbox, polygon, annulus, panda/sector, exclusion
composites) in ``image``, ``fk5``/``icrs``, ``fk4``/``b1950`` (full FK425
incl. E-terms), ``galactic``, ``ecliptic``, and (CRTF) ``supergalactic``
frames.  The rasteriser runs on the host in float64 numpy, so every
boundary pixel is the JAX package's; the union of the regions then goes
to the cube's device once, as one compact ``(1, ny, nx)`` mask that is
broadcast against the data, never materialised at the cube's size.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .masks import BooleanArrayMask

__all__ = ["Region", "CompositeRegion", "parse_ds9_region",
           "parse_crtf_region", "region_to_mask",
           "subcube_from_ds9region", "subcube_from_crtfregion",
           "subcube_from_regions"]


class Region:
    def __init__(self, shape, frame, params, exclude=False, meta=None):
        self.shape = shape      # 'circle' | 'ellipse' | 'box' | 'polygon'
                                # | 'annulus' | 'panda' (sector)
        self.frame = frame      # 'image' | 'fk5' | 'icrs' | 'galactic'
        self.params = params    # floats: pixels (image) or degrees (sky)
        self.exclude = exclude  # ds9/CRTF '-' prefix: subtract this region
        # regions-package-style metadata: 'range' (2 spectral Quantities),
        # 'veltype' (RADIO|OPTICAL|Z|BETA|GAMMA|RELATIVISTIC), 'restfreq'
        # (reference spectral_cube.py:2125-2151)
        self.meta = dict(meta or {})

    def __and__(self, other):
        return CompositeRegion(self, other, "and")

    def __or__(self, other):
        return CompositeRegion(self, other, "or")

    def __xor__(self, other):
        return CompositeRegion(self, other, "xor")


class CompositeRegion:
    """Boolean combination of two regions (the regions-package
    CompositeSkyRegion analog accepted by the reference at
    spectral_cube.py:2038-2174)."""

    exclude = False

    def __init__(self, region1, region2, operation="or"):
        if operation not in ("and", "or", "xor"):
            raise ValueError(f"unknown composite operation {operation!r}")
        self.region1 = region1
        self.region2 = region2
        self.operation = operation

    __and__ = Region.__and__
    __or__ = Region.__or__
    __xor__ = Region.__xor__


# IAU 1958 galactic frame w.r.t. FK5 J2000: the north galactic pole and
# the galactic longitude of the equatorial north pole
_NGP_RA = 192.85948
_NGP_DEC = 27.12825
_L_NCP = 122.93192


def galactic_to_fk5(l, b):
    """(l, b) [deg] -> (ra, dec) [deg].  The galactic frame is a pure
    rotation of FK5: reuse the projection engine's pole-rotation math
    with (alpha_p, delta_p, phi_p) = (NGP, l_NCP)."""
    from .wcs import projections as prj
    return prj.native_to_celestial(np.asarray(l, dtype=float),
                                   np.asarray(b, dtype=float),
                                   _NGP_RA, _NGP_DEC, _L_NCP)


def fk5_to_galactic(ra, dec):
    """(ra, dec) [deg] -> (l, b) [deg]."""
    from .wcs import projections as prj
    lon, lat = prj.celestial_to_native(np.asarray(ra, dtype=float),
                                       np.asarray(dec, dtype=float),
                                       _NGP_RA, _NGP_DEC, _L_NCP)
    return lon % 360.0, lat


# J2000 mean obliquity (IAU 1976: 23 deg 26' 21.448"); the ecliptic frame
# is a pure rotation of FK5 about the equinox
_OBLIQUITY = 23.0 + 26.0 / 60.0 + 21.448 / 3600.0
_ECL_POLE_RA = 270.0
_ECL_POLE_DEC = 90.0 - _OBLIQUITY


def ecliptic_to_fk5(lam, beta):
    """Ecliptic (lambda, beta) [deg] -> FK5 J2000 (ra, dec) [deg]."""
    from .wcs import projections as prj
    return prj.native_to_celestial(np.asarray(lam, dtype=float),
                                   np.asarray(beta, dtype=float),
                                   _ECL_POLE_RA, _ECL_POLE_DEC, 90.0)


def fk5_to_ecliptic(ra, dec):
    """FK5 J2000 (ra, dec) [deg] -> ecliptic (lambda, beta) [deg]."""
    from .wcs import projections as prj
    lon, lat = prj.celestial_to_native(np.asarray(ra, dtype=float),
                                       np.asarray(dec, dtype=float),
                                       _ECL_POLE_RA, _ECL_POLE_DEC, 90.0)
    return lon % 360.0, lat


# FK4 B1950 -> FK5 J2000: the position part of the standard FK425
# transformation (Aoki et al. 1983; SLALIB sla_fk45z, zero proper motion):
# remove the FK4 E-terms of aberration, then rotate by the fixed
# precession+equinox-correction matrix.
_FK4_ETERMS = np.array([-1.62557e-6, -0.31919e-6, -0.13843e-6])
_FK425_M = np.array([
    [0.9999256782, -0.0111820611, -0.0048579477],
    [0.0111820610, 0.9999374784, -0.0000271765],
    [0.0048579479, -0.0000271474, 0.9999881997]])


def _lonlat_to_vec(lon, lat):
    lo, la = np.radians(np.asarray(lon, float)), np.radians(
        np.asarray(lat, float))
    return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                     np.sin(la)], axis=-1)


def _vec_to_lonlat(v):
    lon = np.degrees(np.arctan2(v[..., 1], v[..., 0])) % 360.0
    lat = np.degrees(np.arctan2(v[..., 2],
                                np.hypot(v[..., 0], v[..., 1])))
    return lon, lat


def fk4_to_fk5(ra, dec):
    """FK4 B1950 (ra, dec) [deg] -> FK5 J2000, incl. E-term removal."""
    r = _lonlat_to_vec(ra, dec)
    r1 = r - _FK4_ETERMS + (r @ _FK4_ETERMS)[..., None] * r
    return _vec_to_lonlat(r1 @ _FK425_M.T)


def fk5_to_fk4(ra, dec):
    """FK5 J2000 (ra, dec) [deg] -> FK4 B1950, incl. E-term re-addition."""
    r = _lonlat_to_vec(ra, dec) @ _FK425_M  # M^T inverse (orthogonal)
    r = r / np.linalg.norm(r, axis=-1, keepdims=True)
    # first-order E-term re-addition, one fixed-point refinement
    r1 = r
    for _ in range(3):
        r1 = r + _FK4_ETERMS - (r1 @ _FK4_ETERMS)[..., None] * r1
    return _vec_to_lonlat(r1)


# de Vaucouleurs supergalactic frame: a pure rotation of GALACTIC with
# the pole at (l, b) = (47.37, +6.32) and SGL = 0 toward l = 137.37
_SGP_L, _SGP_B = 47.37, 6.32


def supergalactic_to_galactic(sgl, sgb):
    """Supergalactic (SGL, SGB) [deg] -> galactic (l, b) [deg]."""
    from .wcs import projections as prj
    return prj.native_to_celestial(np.asarray(sgl, dtype=float),
                                   np.asarray(sgb, dtype=float),
                                   _SGP_L, _SGP_B, 90.0)


def galactic_to_supergalactic(l, b):
    """Galactic (l, b) [deg] -> supergalactic (SGL, SGB) [deg]."""
    from .wcs import projections as prj
    lon, lat = prj.celestial_to_native(np.asarray(l, dtype=float),
                                       np.asarray(b, dtype=float),
                                       _SGP_L, _SGP_B, 90.0)
    return lon % 360.0, lat


def _sky_to_wcs_frame(lon, lat, frame, wcs_galactic):
    """Convert region sky coordinates from ``frame`` into the frame of the
    target WCS (FK5/ICRS or galactic).  ICRS is treated as FK5 (they agree
    to ~25 mas, far below a pixel)."""
    lon = np.asarray(lon, dtype=float)
    lat = np.asarray(lat, dtype=float)
    if frame == "ecliptic":
        lon, lat = ecliptic_to_fk5(lon, lat)
        frame = "fk5"
    elif frame in ("fk4", "b1950"):
        lon, lat = fk4_to_fk5(lon, lat)
        frame = "fk5"
    elif frame == "supergalactic":
        lon, lat = supergalactic_to_galactic(lon, lat)
        frame = "galactic"
    if frame == "galactic" and not wcs_galactic:
        return galactic_to_fk5(lon, lat)
    if frame in ("fk5", "icrs") and wcs_galactic:
        return fk5_to_galactic(lon, lat)
    return lon, lat


_ANGLE_RE = re.compile(r'([+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*'
                       r'("|\'|d|deg|arcsec|arcmin|r|rad|p|pix)?')


def _angle_to_deg(token):
    token = token.strip()
    m = _ANGLE_RE.fullmatch(token)
    if m:
        val = float(m.group(1))
        unit = m.group(2)
        if unit in (None, "d", "deg"):
            return val, "deg"
        if unit == '"' or unit == "arcsec":
            return val / 3600.0, "deg"
        if unit == "'" or unit == "arcmin":
            return val / 60.0, "deg"
        if unit in ("r", "rad"):
            return np.degrees(val), "deg"
        if unit in ("p", "pix"):
            return val, "pix"
    # CASA hms/dms forms: 18h12m24.5s (hours -> x15), -23d11m00s /
    # -23d11'00" (degrees)
    hm = re.fullmatch(
        r"([+-]?\d+(?:\.\d*)?)h(?:(\d+(?:\.\d*)?)m"
        r"(?:(\d+(?:\.\d*)?)s?)?)?", token)
    dm = re.fullmatch(
        r"([+-]?\d+(?:\.\d*)?)d(?:(\d+(?:\.\d*)?)[m']"
        r"(?:(\d+(?:\.\d*)?)(?:s|\"|'')?)?)?", token)
    for m2, factor in ((hm, 15.0), (dm, 1.0)):
        if m2:
            sign = -1.0 if m2.group(1).startswith("-") else 1.0
            val = abs(float(m2.group(1)))
            val += float(m2.group(2) or 0.0) / 60.0
            val += float(m2.group(3) or 0.0) / 3600.0
            return sign * val * factor, ("hour" if factor == 15.0
                                         else "deg")
    if ":" in token:  # sexagesimal
        parts = [float(p) for p in token.split(":")]
        sign = -1.0 if token.strip().startswith("-") else 1.0
        val = abs(parts[0]) + parts[1] / 60.0 + (parts[2] if len(parts) > 2
                                                 else 0.0) / 3600.0
        return sign * val, "sex"
    return float(token), "deg"


def parse_ds9_region(region_string):
    """Parse a ds9 region file/string into Region objects."""
    regions = []
    frame = "image"
    # ds9 separates statements with newlines OR semicolons
    # ("fk5; circle(...)" is the common inline form)
    statements = []
    for line in str(region_string).splitlines():
        statements.extend(line.split(";"))
    for line in statements:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        low = line.lower()
        if low in ("image", "fk5", "icrs", "galactic", "physical",
                   "ecliptic", "fk4", "b1950", "j2000"):
            frame = {"physical": "image", "b1950": "fk4",
                     "j2000": "fk5"}.get(low, low)
            continue
        if low.startswith("global"):
            continue
        exclude = low.startswith("-")
        if exclude:
            low = low[1:].lstrip()
        m = re.match(r"([a-z]+)\s*\(([^)]*)\)", low)
        if not m:
            continue
        shape = m.group(1)
        raw = [p.strip() for p in m.group(2).split(",")]
        vals = [_angle_to_deg(p)[0] for p in raw]
        # ds9 equatorial frames write sexagesimal longitudes in HOURS
        if frame in ("fk5", "icrs", "fk4") and shape != "polygon" \
                and ":" in raw[0]:
            vals[0] *= 15.0
        if frame in ("fk5", "icrs", "fk4") and shape == "polygon":
            for k in range(0, len(raw), 2):
                if ":" in raw[k]:
                    vals[k] *= 15.0
        if frame == "image":
            # ds9 image coords are 1-based pixel centers
            if shape in ("circle", "annulus", "panda"):
                vals = [vals[0] - 1, vals[1] - 1] + vals[2:]
            elif shape in ("box", "ellipse"):
                vals = [vals[0] - 1, vals[1] - 1] + vals[2:]
            elif shape == "polygon":
                vals = [v - 1 for v in vals]
        regions.append(Region(shape, frame, vals, exclude=exclude))
    return regions


def parse_crtf_region(region_string):
    """Parse a (simple) CASA CRTF region string."""
    regions = []
    for line in str(region_string).splitlines():
        line = line.strip()
        if not line or line.startswith("#CRTF") or line.startswith("#"):
            continue
        exclude = line.startswith("-")
        if exclude:
            line = line[1:].lstrip()
        elif line.startswith("+"):
            line = line[1:].lstrip()
        m = re.match(r"(circle|ellipse|box|rotbox|centerbox|poly|annulus)"
                     r"\s*\[\s*\[([^\]]*)\]\s*,?\s*(.*)", line,
                     re.IGNORECASE)
        if not m:
            continue
        shape = m.group(1).lower()
        center = [p.strip() for p in m.group(2).split(",")]
        rest = m.group(3)
        frame = "fk5"
        if "coord=" in rest.lower():
            fm = re.search(r"coord=(\w+)", rest, re.IGNORECASE)
            if fm:
                frame = fm.group(1).lower()
                frame = {"j2000": "fk5", "icrs": "icrs",
                         "galactic": "galactic", "b1950": "fk4",
                         "fk4": "fk4", "ecliptic": "ecliptic",
                         "supergal": "supergalactic"}.get(frame, "fk5")
        def coord_pair(tokens):
            vx, ux = _angle_to_deg(tokens[0])
            vy, uy = _angle_to_deg(tokens[1])
            # CRTF hms / colon-form longitudes are hours (x15); the dms
            # and explicit-unit forms are already degrees
            if ux in ("hour",):
                pass  # already multiplied
            elif ux == "sex" and frame in ("fk5", "icrs", "fk4"):
                vx *= 15.0
            return vx, vy, ux

        groups = [center] + [
            [p.strip() for p in g.split(",")]
            for g in re.findall(r"\[([^\]]*)\]", rest)]
        # a bare trailing token after the last bracket is the rotation
        # angle (rotbox/ellipse): "..., [2arcmin,1arcmin], 45deg"
        tail = re.sub(r"\[[^\]]*\]", "", rest)
        tail_tokens = [t.strip().rstrip("]").strip()
                       for t in tail.split(",")
                       if t.strip().rstrip("]").strip()
                       and "=" not in t]
        cx, cy, cxu = coord_pair(groups[0])
        if cxu == "pix":
            frame = "image"
        if shape == "poly":
            params = []
            for g in groups:
                vx, vy, _ = coord_pair(g)
                params.extend([vx, vy])
            regions.append(Region("polygon", frame, params,
                                  exclude=exclude))
            continue
        if shape == "box" and len(groups) > 1:
            # plain CRTF box is corner-specified [[blc],[trc]]; convert
            # to the center+size form the rasterizer uses.  The width the
            # rasterizer wants is an ARC length: a longitude-coordinate
            # difference must shrink by cos(dec) (at dec=60 a raw RA
            # difference is 2x too wide)
            x2, y2, _ = coord_pair(groups[1])
            wx = abs(x2 - cx)
            ctr_y = (cy + y2) / 2.0
            if frame != "image":
                wx *= abs(np.cos(np.radians(ctr_y)))
            params = [(cx + x2) / 2.0, ctr_y, wx, abs(y2 - cy)]
            regions.append(Region("box", frame, params, exclude=exclude))
            continue
        params = [cx, cy]
        if len(groups) > 1:
            for tok in groups[1]:
                params.append(_angle_to_deg(tok)[0])
        elif tail_tokens:
            params.append(_angle_to_deg(tail_tokens[0])[0])
            tail_tokens = tail_tokens[1:]
        if shape in ("rotbox", "ellipse", "centerbox") and tail_tokens:
            # rotation angle (degrees) after the size bracket
            try:
                params.append(_angle_to_deg(tail_tokens[0])[0])
            except ValueError:
                pass
        name = {"rotbox": "box", "centerbox": "box"}.get(shape, shape)
        regions.append(Region(name, frame, params, exclude=exclude))
    return regions


def region_to_mask(region, wcs, shape):
    """Rasterize one region into a (ny, nx) boolean array."""
    if isinstance(region, CompositeRegion):
        m1 = region_to_mask(region.region1, wcs, shape)
        m2 = region_to_mask(region.region2, wcs, shape)
        return {"and": m1 & m2, "or": m1 | m2,
                "xor": m1 ^ m2}[region.operation]
    nchan, ny, nx = shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(float)
    cel = wcs.celestial
    # which trailing params are lengths (to be converted from sky degrees
    # to pixels); the rest (angles in deg, integer counts) pass through
    _length_slots = {"circle": (0,), "annulus": None,  # all radii
                     "ellipse": (0, 1), "box": (0, 1),
                     "panda": (3, 4)}
    if region.frame == "image":
        px, py = xx, yy
        cx, cy = region.params[0], region.params[1]
        rest = region.params[2:]
        scale = 1.0  # sizes in pixels
    else:
        # sky frame: convert region center/size into pixels via the WCS;
        # galactic<->equatorial mismatches go through the fixed IAU
        # rotation (radii are rotation-invariant; box/ellipse position
        # angles keep their value — exact for circles/annuli/polygons,
        # a small-field approximation for rotated shapes)
        wcs_galactic = wcs.ctype[0].upper().startswith("GLON")
        cxw, cyw = (float(v) for v in _sky_to_wcs_frame(
            region.params[0], region.params[1], region.frame, wcs_galactic))
        cxp, cyp = cel.world2pix(np.array([cxw]), np.array([cyw]))
        cx, cy = float(np.asarray(cxp)[0]), float(np.asarray(cyp)[0])
        px, py = xx, yy
        pixscale = float(np.mean(np.abs(cel.proj_plane_pixel_scales())))
        slots = _length_slots.get(region.shape, ())
        rest = [r / pixscale
                if (slots is None or i in slots) else r
                for i, r in enumerate(region.params[2:])]
        scale = 1.0
        if region.shape in ("box", "ellipse") and len(rest) > 2:
            # sky position angles are east-of-north; convert to the
            # pixel-frame math angle via the local north/east directions
            # (handles mirrored x (CDELT1<0) and rotated PC exactly —
            # keeping the raw value flipped the rotation's handedness)
            eps_deg = pixscale
            nxp, nyp = cel.world2pix(np.array([cxw]),
                                     np.array([cyw + eps_deg]))
            north = np.array([float(np.asarray(nxp)[0]) - cx,
                              float(np.asarray(nyp)[0]) - cy])
            exp_, eyp_ = cel.world2pix(
                np.array([cxw + eps_deg / max(np.cos(np.radians(cyw)),
                                              1e-6)]),
                np.array([cyw]))
            east = np.array([float(np.asarray(exp_)[0]) - cx,
                             float(np.asarray(eyp_)[0]) - cy])
            north /= max(np.hypot(*north), 1e-12)
            east /= max(np.hypot(*east), 1e-12)
            pa = np.radians(rest[2])
            # ds9/regions convention: at angle 0 the WIDTH axis lies
            # along the longitude (east) direction; the angle rotates it
            # counterclockwise toward north.  The rasterizer's theta is
            # the width axis's pixel-frame angle (anchoring the height
            # axis instead silently swapped w and h for sky boxes —
            # pinned by the reference fk5.reg fixture, which selects
            # exactly row 1 of the adv cube).
            direction = np.cos(pa) * east + np.sin(pa) * north
            rest[2] = float(np.degrees(np.arctan2(direction[1],
                                                  direction[0])))
    if region.shape == "circle":
        r = rest[0] * scale
        mask2d = (px - cx) ** 2 + (py - cy) ** 2 <= r ** 2
    elif region.shape == "annulus":
        # ds9 annulus(x, y, r1, r2[, r3 ...]): innermost..outermost ring
        radii = sorted(r * scale for r in rest)
        r_in, r_out = radii[0], radii[-1]
        d2 = (px - cx) ** 2 + (py - cy) ** 2
        mask2d = (d2 >= r_in ** 2) & (d2 <= r_out ** 2)
    elif region.shape == "panda":
        # ds9 panda(x, y, ang1, ang2, nang, r1, r2, nrad): a sector slice
        # of an annulus; counts are ignored (single sector like ds9's
        # bounding panda region)
        ang1, ang2 = rest[0], rest[1]
        r_in, r_out = sorted((rest[3] * scale, rest[4] * scale))
        dx, dy = px - cx, py - cy
        d2 = dx ** 2 + dy ** 2
        theta = np.degrees(np.arctan2(dy, dx)) % 360.0
        a1, a2 = ang1 % 360.0, ang2 % 360.0
        if a2 >= a1:
            in_ang = (theta >= a1) & (theta <= a2)
        else:  # wraps through 0
            in_ang = (theta >= a1) | (theta <= a2)
        mask2d = (d2 >= r_in ** 2) & (d2 <= r_out ** 2) & in_ang
    elif region.shape == "ellipse":
        a, b = rest[0] * scale, rest[1] * scale
        theta = np.deg2rad(rest[2] if len(rest) > 2 else 0.0)
        dx, dy = px - cx, py - cy
        xr = dx * np.cos(theta) + dy * np.sin(theta)
        yr = -dx * np.sin(theta) + dy * np.cos(theta)
        mask2d = (xr / a) ** 2 + (yr / b) ** 2 <= 1.0
    elif region.shape == "box":
        w, h = rest[0] * scale, rest[1] * scale
        theta = np.deg2rad(rest[2] if len(rest) > 2 else 0.0)
        dx, dy = px - cx, py - cy
        xr = dx * np.cos(theta) + dy * np.sin(theta)
        yr = -dx * np.sin(theta) + dy * np.cos(theta)
        mask2d = (np.abs(xr) <= w / 2) & (np.abs(yr) <= h / 2)
    elif region.shape == "polygon":
        if region.frame == "image":
            vx = np.array(region.params[0::2])
            vy = np.array(region.params[1::2])
        else:
            wcs_galactic = wcs.ctype[0].upper().startswith("GLON")
            vxw, vyw = _sky_to_wcs_frame(np.array(region.params[0::2]),
                                         np.array(region.params[1::2]),
                                         region.frame, wcs_galactic)
            vxp, vyp = cel.world2pix(vxw, vyw)
            vx, vy = np.asarray(vxp), np.asarray(vyp)
        mask2d = _point_in_poly(px, py, vx, vy)
    else:
        raise ValueError(f"unsupported region shape {region.shape!r}")
    return mask2d


def _point_in_poly(px, py, vx, vy):
    inside = np.zeros(px.shape, dtype=bool)
    n = len(vx)
    j = n - 1
    for i in range(n):
        cond = ((vy[i] > py) != (vy[j] > py)) & (
            px < (vx[j] - vx[i]) * (py - vy[i]) /
            (vy[j] - vy[i] + 1e-300) + vx[i])
        inside ^= cond
        j = i
    return inside


def _region_spectral_slab(cube, regions):
    """Spectral slab selected by the regions' ``meta['range']`` entries
    (reference spectral_cube.py:2143-2151 + the veltype/restfreq
    conversion of _velocity_freq_conversion_regions, :2176-2235).
    Returns the cube unchanged when any region lacks a range."""
    metas = [dict(getattr(r, "meta", None) or {}) for r in regions]
    if not metas or any(m.get("range") is None for m in metas):
        return cube
    from .units import (Quantity, doppler_radio, doppler_optical, doppler_z,
                        doppler_beta, doppler_gamma, doppler_relativistic,
                        spectral)
    from .wcs.spectral import determine_vconv_from_ctype, _rest_freq_si
    eqv = {"RADIO": doppler_radio, "OPTICAL": doppler_optical,
           "Z": doppler_z, "BETA": doppler_beta, "GAMMA": doppler_gamma,
           "RELATIVISTIC": doppler_relativistic,
           # our internal convention names too
           "radio": doppler_radio, "optical": doppler_optical,
           "relativistic": doppler_relativistic}
    vconv_cube = determine_vconv_from_ctype(cube._wcs.ctype[2])
    cube_eqv = eqv.get(str(vconv_cube), doppler_radio)
    restfreq_cube = Quantity(_rest_freq_si(cube._wcs), "Hz")
    spec_unit = cube.spectral_unit
    endpoints = []
    for meta in metas:
        rng = meta["range"]
        veltype = meta.get("veltype")
        if veltype is not None and str(veltype).upper() not in eqv:
            raise ValueError(
                f"Spectral Cube doesn't support the {veltype} type of "
                "velocity")
        region_eqv = eqv[str(veltype).upper()] if veltype is not None \
            else cube_eqv
        restfreq = meta.get("restfreq")
        restfreq = restfreq_cube if restfreq is None \
            else restfreq.to("Hz", equivalencies=spectral())
        lo_hi = []
        for val in rng:
            q = val if isinstance(val, Quantity) else Quantity(val, spec_unit)
            f = q.to("Hz", equivalencies=region_eqv(restfreq))
            lo_hi.append(f.to(spec_unit,
                              equivalencies=cube_eqv(restfreq_cube)))
        endpoints.extend(lo_hi)
    vals = np.array([float(q.value) for q in endpoints])
    return cube.spectral_slab(Quantity(vals.min(), spec_unit),
                              Quantity(vals.max(), spec_unit))


def _extract(cube, regions, allow_empty=False, minimize=True):
    """OR the include-regions, then subtract exclusion ('-'-prefixed)
    regions — ds9/CRTF composite semantics."""
    cube = _region_spectral_slab(cube, regions)
    mask2d = np.zeros(cube.shape[1:], dtype=bool)
    for reg in regions:
        if not getattr(reg, "exclude", False):
            mask2d |= region_to_mask(reg, cube.wcs, cube.shape)
    for reg in regions:
        if getattr(reg, "exclude", False):
            mask2d &= ~region_to_mask(reg, cube.wcs, cube.shape)
    if not mask2d.any() and not allow_empty:
        raise ValueError("The derived subset is empty: the region does not "
                         "overlap with the cube")
    mask = BooleanArrayMask(torch.as_tensor(mask2d[None, :, :],
                                            device=cube.device),
                            wcs=cube.wcs, shape=cube.shape)
    out = cube.with_mask(mask)
    if minimize:
        out = out.minimal_subcube(spatial_only=True)
    return out


def _region_text(region):
    """A region file's text, or the string itself."""
    import os
    if os.path.exists(str(region)):
        with open(region) as fh:
            return fh.read()
    return region


def subcube_from_ds9region(cube, ds9_region, allow_empty=False):
    return _extract(cube, parse_ds9_region(_region_text(ds9_region)),
                    allow_empty=allow_empty)


def subcube_from_crtfregion(cube, crtf_region, allow_empty=False):
    return _extract(cube, parse_crtf_region(_region_text(crtf_region)),
                    allow_empty=allow_empty)


def subcube_from_regions(cube, region_list, allow_empty=False,
                         minimize=True):
    return _extract(cube, list(region_list), allow_empty=allow_empty,
                    minimize=minimize)
