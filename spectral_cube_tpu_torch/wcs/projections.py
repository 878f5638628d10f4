"""Celestial projection math (FITS WCS Paper II, Calabretta & Greisen 2002).

The reference library delegates all of this to astropy's wcslib C wrapper;
this framework implements the projections it needs natively, as vectorized
numpy on the host and as pure-jnp functions usable inside jit on device
(see :func:`make_pix2world_fn`).

Supported codes: TAN, SIN (incl. slant orthographic with PV2_1=xi,
PV2_2=eta — the radio-interferometry / AIPS NCP case), ARC, STG, ZEA,
AZP (PV2_1=mu, PV2_2=gamma tilt), SZP (PV2_1=mu, PV2_2=phi_c,
PV2_3=theta_c), ZPN (zenithal polynomial PV2_0..PV2_29), AIR
(PV2_1=theta_b), CAR, CEA (PV2_1=lambda), MER, MOL, SFL/GLS, AIT, CYP
(PV2_1=mu, PV2_2=lambda), PAR, the pseudoconics BON (PV2_1=theta_1) and
PCO, the conic family COP/COE/COD/COO (PV2_1=theta_a, PV2_2=eta), the
HEALPix grid HPX (PV2_1=H, PV2_2=K — e.g. the HI4PI survey release), and
the quad-cubes TSC (tangential/gnomonic) and QSC (the O'Neill &
Laubscher 1976 quadrilateralized spherical cube — exactly equal-area,
validated against an mpmath sector-area quadrature oracle and a
constant-Jacobian property test), and the polar HEALPix butterfly XPH
(Calabretta & Lowe 2013): the H=4, K=3 HEALPix gores re-hinged at the
north pole and fanned along the map diagonals.  XPH's layout is pinned
from first principles rather than copied: (a) the fiducial point is the
pole, (b) the native azimuth convention matches every other
pole-centered projection (phi = 0 along -y, increasing toward +x), (c)
adjacent gores must share their polar-cap edge continuously (which
forces the chi = +-45/+-135 gore->wing rotation assignment derived in
``_xph_native2xy``), and (d) the map is exactly equal-area with the HPX
Jacobian (no hidden scale); the tests assert all four properties.  CSC
remains unimplemented: it is defined by the COBE polynomial coefficient
tables (data, not math — ~4e-4 deg approximation error by
construction) and does not appear in spectral-line radio data.  All functions
work on *intermediate world coordinates* (x, y) in **degrees** and native
spherical coordinates (phi, theta) in **degrees**, matching wcslib
conventions.  ``pv`` holds the PVi_m values of the latitude axis: either a
tuple indexed by m-1 (m >= 1) or a dict ``{m: value}`` (which can carry
m=0, needed by ZPN).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SUPPORTED_PROJECTIONS",
    "proj_xy2native",
    "proj_native2xy",
    "native_to_celestial",
    "celestial_to_native",
    "celestial_pole",
]

D2R = np.pi / 180.0
R2D = 180.0 / np.pi

SUPPORTED_PROJECTIONS = ("TAN", "SIN", "ARC", "STG", "ZEA", "AZP", "SZP",
                         "ZPN", "AIR",
                         "CAR", "CEA", "MER", "MOL", "SFL", "GLS", "AIT",
                         "CYP", "PAR", "BON", "PCO", "HPX", "XPH",
                         "COP", "COE", "COD", "COO", "TSC", "QSC", "")

# Fiducial native coordinates (phi0, theta0) per projection family [deg].
_ZENITHAL = {"TAN", "SIN", "ARC", "STG", "ZEA", "AZP", "SZP", "ZPN", "AIR"}
_CYLINDRICAL = {"CAR", "CEA", "MER", "MOL", "SFL", "GLS", "AIT",
                "CYP", "PAR", "BON", "PCO", "HPX", "TSC", "QSC", ""}
_CONIC = {"COP", "COE", "COD", "COO"}


def _pv(pv, m, default):
    if isinstance(pv, dict):
        v = pv.get(m)
        return default if v is None else float(v)
    try:
        v = pv[m - 1]
    except (IndexError, TypeError):
        return default
    return default if v is None else float(v)


def _zpn_coeffs(pv):
    """ZPN polynomial coefficients P_0..P_K as a list (PV2_m, m=0..29)."""
    if isinstance(pv, dict):
        ms = [m for m in pv if pv[m] is not None]
    else:
        ms = [m + 1 for m, v in enumerate(pv) if v is not None]
    k = max(ms, default=0)
    coeffs = [_pv(pv, m, 0.0) for m in range(k + 1)]
    if not any(coeffs):
        raise ValueError("ZPN requires at least one nonzero PV2_m "
                         "coefficient")
    return coeffs


def fiducial_native(code: str, pv=()):
    if code in _ZENITHAL or code == "XPH":
        # XPH is pole-centered like the zenithal family (the butterfly's
        # body is the north pole), so its fiducial point is the pole too.
        return 0.0, 90.0
    if code in _CONIC:
        # conics put the fiducial point on the middle parallel theta_a
        return 0.0, _pv(pv, 1, 0.0)
    return 0.0, 0.0


def _conic_params(code, pv, xp):
    """(C, R(theta) [deg], Y0 [deg]) for the conic family, derived from
    the two standard parallels theta_1,2 = theta_a -+ eta (PV2_1, PV2_2):

    - COP: perspective projection onto the cone tangent at theta_a,
      scaled by cos(eta) (secant-cone convention),
    - COE: equal-area (Albers): C and R from dA_map == dA_sphere plus
      true scale at both standard parallels,
    - COD: equidistant: |dR/dtheta| == 1 plus true scale at both,
    - COO: conformal (Lambert): s_par == s_mer plus true scale at both.

    Returns (C, R(theta_deg)->deg, Rinv(R_deg)->theta_deg, Y0).
    """
    ta = _pv(pv, 1, 0.0)
    eta = _pv(pv, 2, 0.0)
    ta_r, eta_r = ta * D2R, eta * D2R
    t1, t2 = ta_r - eta_r, ta_r + eta_r
    if code == "COP":
        C = np.sin(ta_r)
        cot_a = 1.0 / np.tan(ta_r)

        def R(theta):
            t = theta * D2R
            return R2D * np.cos(eta_r) * (cot_a - xp.tan(t - ta_r))

        def Rinv(r):
            return ta + xp.arctan(cot_a - r * D2R / np.cos(eta_r)) * R2D
    elif code == "COE":
        gamma = np.sin(t1) + np.sin(t2)
        C = gamma / 2.0
        s1s2 = np.sin(t1) * np.sin(t2)

        def R(theta):
            t = theta * D2R
            return (2.0 * R2D / gamma) * xp.sqrt(
                xp.maximum(1.0 + s1s2 - gamma * xp.sin(t), 0.0))

        def Rinv(r):
            sin_t = (1.0 + s1s2 - (gamma * r * D2R / 2.0) ** 2) / gamma
            return xp.arcsin(xp.clip(sin_t, -1.0, 1.0)) * R2D
    elif code == "COD":
        if eta == 0.0:
            C = np.sin(ta_r)
            R0 = R2D * np.cos(ta_r) / np.sin(ta_r)
        else:
            C = np.sin(ta_r) * np.sin(eta_r) / eta_r
            R0 = eta * np.cos(ta_r) * np.cos(eta_r) / (np.sin(ta_r)
                                                       * np.sin(eta_r))

        def R(theta):
            return R0 + (ta - theta)

        def Rinv(r):
            return ta + R0 - r
    elif code == "COO":
        c1, c2 = np.cos(t1), np.cos(t2)
        tan1 = np.tan((np.pi / 2 - t1) / 2.0)
        tan2 = np.tan((np.pi / 2 - t2) / 2.0)
        if eta == 0.0 or abs(tan1 - tan2) < 1e-14:
            C = np.sin(ta_r)
        else:
            C = np.log(c2 / c1) / np.log(tan2 / tan1)
        psi = R2D * c1 / (C * tan1 ** C)

        def R(theta):
            t = theta * D2R
            return psi * xp.tan((np.pi / 2 - t) / 2.0) ** C

        def Rinv(r):
            return 90.0 - 2.0 * xp.arctan(
                xp.maximum(r / psi, 0.0) ** (1.0 / C)) * R2D
    else:
        raise ValueError(f"not a conic: {code!r}")
    # fiducial point (0, theta_a) maps to (x, y) = (0, 0)
    Y0 = float(np.asarray(R(np.float64(ta))))
    return C, R, Rinv, Y0


def _zenithal_r_to_theta(code, r, xp, pv=()):
    """R_theta [deg] -> theta [deg] for radially-symmetric zenithals
    (AZP and slant SIN are handled separately: their (x, y) maps are not
    radially symmetric once the PV obliquity parameters are nonzero)."""
    if code == "ZPN":
        return _zpn_r_to_theta(r, xp, pv)
    if code == "AIR":
        return _air_r_to_theta(r, xp, pv)
    if code == "TAN":
        return xp.arctan2(R2D, r) * R2D
    if code == "SIN":
        return xp.arccos(xp.clip(r * D2R, -1.0, 1.0)) * R2D
    if code == "ARC":
        return 90.0 - r
    if code == "STG":
        return 90.0 - 2.0 * xp.arctan(r * D2R / 2.0) * R2D
    if code == "ZEA":
        return 90.0 - 2.0 * xp.arcsin(xp.clip(r * D2R / 2.0, -1.0, 1.0)) * R2D
    raise ValueError(f"unsupported zenithal projection {code!r}")


def _zenithal_theta_to_r(code, theta, xp, pv=()):
    t = theta * D2R
    if code == "ZPN":
        coeffs = _zpn_coeffs(pv)
        zeta = (np.pi / 2.0) - t
        r = coeffs[-1] * xp.ones_like(zeta) if len(coeffs) > 1 \
            else coeffs[-1]
        for c in coeffs[-2::-1]:
            r = r * zeta + c
        return R2D * r
    if code == "AIR":
        return _air_theta_to_r(theta, xp, pv)
    if code == "TAN":
        return R2D * xp.cos(t) / xp.maximum(xp.sin(t), 1e-300)
    if code == "SIN":
        return R2D * xp.cos(t)
    if code == "ARC":
        return 90.0 - theta
    if code == "STG":
        return 2.0 * R2D * xp.tan((np.pi / 2.0 - t) / 2.0)
    if code == "ZEA":
        return 2.0 * R2D * xp.sin((np.pi / 2.0 - t) / 2.0)
    raise ValueError(f"unsupported zenithal projection {code!r}")


def _zpn_r_to_theta(r, xp, pv):
    """ZPN inverse: solve sum_k P_k zeta^k = r [rad] for zeta = 90 - theta
    by Newton iteration (fixed count, jit-friendly).  The polynomial is
    monotonic over the domain of any sane ZPN header (wcslib validates the
    same way by locating the first turning point)."""
    coeffs = _zpn_coeffs(pv)
    target = r * D2R

    def poly_and_deriv(z):
        p = coeffs[-1] * xp.ones_like(z) if len(coeffs) > 1 else coeffs[-1]
        dp = xp.zeros_like(z)
        for c in coeffs[-2::-1]:
            dp = dp * z + p
            p = p * z + c
        return p, dp

    # start from the linear-term estimate (P1 ~ 1 for real headers), or
    # the target itself when P1 is degenerate
    p1 = coeffs[1] if len(coeffs) > 1 else 0.0
    z = (target - coeffs[0]) / p1 if p1 != 0.0 else target
    z = xp.clip(xp.asarray(z, dtype=xp.float64 if xp is np else None),
                0.0, np.pi)
    for _ in range(40):
        f, df = poly_and_deriv(z)
        step = (f - target) / xp.where(xp.abs(df) > 1e-14, df, 1e-14)
        z = xp.clip(z - step, 0.0, np.pi)
    return 90.0 - z * R2D


def _azp_native2xy(phi, theta, xp, pv):
    """AZP forward incl. the tilted-projector gamma (Calabretta & Greisen
    2002 eq. 20-21): perspective from (0, 0, -mu) onto the plane through
    (0, 0, 1) tilted by gamma about the native x = cos(theta)cos(phi)
    direction."""
    mu = _pv(pv, 1, 0.0)
    gam = _pv(pv, 2, 0.0) * D2R
    t, p = theta * D2R, phi * D2R
    ct, st = xp.cos(t), xp.sin(t)
    denom = mu + st + ct * xp.cos(p) * np.tan(gam)
    rr = R2D * (mu + 1.0) * ct / denom
    return rr * xp.sin(p), -rr * xp.cos(p) / np.cos(gam)


def _azp_xy2native(x, y, xp, pv):
    """AZP inverse as an exact ray-sphere intersection: the plane point of
    (x, y) is joined to the projector at (0, 0, -mu) and intersected with
    the unit sphere, taking the intersection nearer the native pole
    (wcslib's branch convention).  Handles mu = 0 and nonzero gamma
    uniformly."""
    mu = _pv(pv, 1, 0.0)
    gam = _pv(pv, 2, 0.0) * D2R
    xr, yr = x * D2R, y * D2R
    # plane point (0,0,1) + xr*e1 - yr*e2, e1=(0,1,0), e2=(cos g, 0, -sin g)
    # => ray direction d from the projector (0, 0, -mu):
    dx = -yr * np.cos(gam)
    dy = xr
    dz = 1.0 + mu + yr * np.sin(gam)
    d2 = dx * dx + dy * dy + dz * dz
    # |(0,0,-mu) + t d|^2 = 1
    disc = mu * mu * dz * dz - d2 * (mu * mu - 1.0)
    t = (mu * dz + xp.sqrt(xp.maximum(disc, 0.0))) / d2
    xu, yu, zu = t * dx, t * dy, t * dz - mu
    phi = xp.arctan2(yu, xu) * R2D
    theta = xp.arctan2(zu, xp.sqrt(xu * xu + yu * yu)) * R2D
    return phi, theta


def _sin_native2xy(phi, theta, xp, pv):
    """Slant orthographic (SIN with PV2_1 = xi, PV2_2 = eta): orthographic
    projection along the direction (-eta, xi, 1) — the AIPS NCP geometry
    when xi = 0, eta = cot(delta_0)."""
    xi, eta = _pv(pv, 1, 0.0), _pv(pv, 2, 0.0)
    t, p = theta * D2R, phi * D2R
    ct, w = xp.cos(t), 1.0 - xp.sin(t)
    x = R2D * (ct * xp.sin(p) + xi * w)
    y = -R2D * (ct * xp.cos(p) - eta * w)
    return x, y


def _sin_xy2native(x, y, xp, pv):
    """Slant orthographic inverse: with X = x rad, Y = y rad and
    w = 1 - sin(theta), the forward map gives the quadratic
    (xi^2+eta^2+1) w^2 - 2 (xi X + eta Y + 1) w + (X^2+Y^2) = 0, solved
    in the cancellation-free form w = C / (B + sqrt(B^2 - A C))."""
    xi, eta = _pv(pv, 1, 0.0), _pv(pv, 2, 0.0)
    X, Y = x * D2R, y * D2R
    A = xi * xi + eta * eta + 1.0
    B = xi * X + eta * Y + 1.0
    C = X * X + Y * Y
    w = C / (B + xp.sqrt(xp.maximum(B * B - A * C, 0.0)))
    # theta via atan2(sin, cos) with cos^2 = w (2 - w): arcsin(1 - w) would
    # lose half the float64 digits near the pole (w -> 0)
    theta = xp.arctan2(1.0 - w,
                       xp.sqrt(xp.maximum(w * (2.0 - w), 0.0))) * R2D
    phi = xp.arctan2(X - xi * w, -(Y - eta * w)) * R2D
    return phi, theta


def _szp_projector(pv):
    """SZP projector point P in image-aligned 3-D coordinates.

    Paper II specifies P by its distance mu from the sphere center
    (PV2_1) and the native coordinates of the point *diametrically
    opposite* it (phi_c = PV2_2, theta_c = PV2_3, default (0, 90)), so
    P = -mu * u(phi_c, theta_c) and the defaults reduce SZP to
    untilted AZP with the same mu (asserted in tests)."""
    mu = _pv(pv, 1, 0.0)
    pc = _pv(pv, 2, 0.0) * D2R
    tc = _pv(pv, 3, 90.0) * D2R
    # image frame: s1 = cos(t) sin(p), s2 = -cos(t) cos(p), s3 = sin(t)
    return (-mu * np.cos(tc) * np.sin(pc),
            mu * np.cos(tc) * np.cos(pc),
            -mu * np.sin(tc))


def _szp_native2xy(phi, theta, xp, pv):
    """Slant zenithal perspective: project from P onto the plane z = 1
    tangent at the native pole (Calabretta & Greisen 2002 sect. 5.1.2)."""
    p1, p2, p3 = _szp_projector(pv)
    t, p = theta * D2R, phi * D2R
    ct = xp.cos(t)
    s1, s2, s3 = ct * xp.sin(p), -ct * xp.cos(p), xp.sin(t)
    f = (1.0 - p3) / (s3 - p3)
    return R2D * (p1 + f * (s1 - p1)), R2D * (p2 + f * (s2 - p2))


def _szp_xy2native(x, y, xp, pv):
    """SZP inverse as an exact ray-sphere intersection (same branch
    convention as AZP: the intersection farther along the ray from the
    projector, i.e. nearer the native pole)."""
    p1, p2, p3 = _szp_projector(pv)
    d1, d2, d3 = x * D2R - p1, y * D2R - p2, 1.0 - p3
    dd = d1 * d1 + d2 * d2 + d3 * d3
    pd = p1 * d1 + p2 * d2 + p3 * d3
    pp = p1 * p1 + p2 * p2 + p3 * p3
    disc = pd * pd - dd * (pp - 1.0)
    t = (-pd + xp.sqrt(xp.maximum(disc, 0.0))) / dd
    s1, s2, s3 = p1 + t * d1, p2 + t * d2, p3 + t * d3
    phi = xp.arctan2(s1, -s2) * R2D
    theta = xp.arctan2(s3, xp.sqrt(s1 * s1 + s2 * s2)) * R2D
    return phi, theta


def _precise_log(x, xp):
    """Natural log.  The port evaluates projections on the host in
    float64 only, where ``log`` is already correctly rounded."""
    return xp.log(x)


def _air_cb(pv):
    """AIR boundary coefficient ln(cos xi_b)/tan^2(xi_b) for
    xi_b = (90 - theta_b)/2, theta_b = PV2_1 (default 90 -> -1/2)."""
    thb = _pv(pv, 1, 90.0)
    xib = (90.0 - thb) * D2R / 2.0
    if abs(xib) < 1e-6:
        return -0.5 + xib * xib / 4.0
    return float(np.log(np.cos(xib)) / np.tan(xib) ** 2)


def _air_lncos_over_tan(xi, xp):
    """ln(cos xi)/tan(xi), series-continued through xi = 0, using the
    ulp-accurate ``_precise_log`` (ln cos = log(cos^2)/2)."""
    small = xp.abs(xi) < 0.02
    safe = xp.where(small, 1.0, xi)
    s, c = xp.sin(safe), xp.cos(safe)
    return xp.where(small, -xi / 2.0 + xi ** 3 / 12.0,
                    0.5 * _precise_log(c * c, xp) * c / s)


def _air_theta_to_r(theta, xp, pv):
    """Airy projection (minimum total distortion inside theta_b):
    R = -2 [ln(cos xi)/tan(xi) + c_b tan(xi)], xi = (90 - theta)/2.
    The closed form satisfies the Euler-Lagrange equation of Airy's
    least-squares criterion (asserted by the mpmath oracle generator)."""
    cb = _air_cb(pv)
    xi = (90.0 - theta) * D2R / 2.0
    return -2.0 * R2D * (_air_lncos_over_tan(xi, xp)
                         + cb * xp.sin(xi) / xp.cos(xi))


def _air_r_to_theta(r, xp, pv):
    """AIR inverse by Newton iteration on xi (R is monotonic in xi over
    the domain of any sane header; fixed count, jit-friendly)."""
    cb = _air_cb(pv)
    target = r * D2R
    xi = xp.clip(target / (1.0 - 2.0 * cb), 0.0, 1.45)
    for _ in range(30):
        s, c = xp.sin(xi), xp.cos(xi)
        f = -2.0 * (_air_lncos_over_tan(xi, xp) + cb * s / c) - target
        small = xp.abs(xi) < 0.02
        s2 = xp.where(small, 0.5, s * s)
        c2 = xp.where(small, 0.5, c * c)
        dterm = xp.where(small, -0.5 + xi * xi / 4.0,
                         -1.0 - 0.5 * _precise_log(c2, xp) / s2)
        df = -2.0 * (dterm + cb / (c * c))
        step = f / xp.where(xp.abs(df) > 1e-14, df, 1e-14)
        xi = xp.clip(xi - step, 0.0, 1.5)
    return 90.0 - 2.0 * xi * R2D


def _hpx_params(pv):
    h = _pv(pv, 1, 4.0)
    k = _pv(pv, 2, 3.0)
    return h, k


def _hpx_facet_center(lon, h, k, south, xp):
    """Longitude of the polar facet center containing ``lon`` [deg,
    wrapped to [-180, 180)].  For even K the southern facets are offset
    by half a facet width (Calabretta & Roukema 2007 sect. 2.2); the
    facet index wraps modulo H so longitudes within the offset of -180
    land on the facet that straddles the +-180 seam (clipping would
    put them ~180 deg away)."""
    w = 180.0 / h
    offs = w if int(round(k)) % 2 == 0 else 0.0
    off = xp.where(south, offs, 0.0) if offs else 0.0
    i = xp.floor((lon + 180.0 - off) / (2.0 * w))
    i = i - xp.floor(i / h) * h            # i mod h, jnp-safe
    return -180.0 + (2.0 * i + 1.0) * w + off


def _hpx_native2xy(phi, theta, xp, pv):
    """HEALPix projection (Calabretta & Roukema 2007): equal-area hybrid
    of interrupted Collignon polar facets over a cylindrical equal-area
    equatorial belt.  H = PV2_1 (default 4), K = PV2_2 (default 3)."""
    h, k = _hpx_params(pv)
    w = 180.0 / h
    lon = (phi + 180.0) % 360.0 - 180.0
    st = xp.sin(theta * D2R)
    polar = xp.abs(st) > (k - 1.0) / k
    y_eq = (90.0 * k / h) * st
    sigma = xp.sqrt(xp.maximum(k * (1.0 - xp.abs(st)), 0.0))
    lon_c = _hpx_facet_center(lon, h, k, st < 0, xp)
    dlon = (lon - lon_c + 180.0) % 360.0 - 180.0   # wrap across the seam
    x_pol = lon_c + dlon * sigma
    y_pol = xp.where(st < 0, -1.0, 1.0) * w * ((k + 1.0) / 2.0 - sigma)
    return xp.where(polar, x_pol, lon), xp.where(polar, y_pol, y_eq)


def _hpx_xy2native(x, y, xp, pv):
    h, k = _hpx_params(pv)
    w = 180.0 / h
    polar = xp.abs(y) > 90.0 * (k - 1.0) / h
    st_eq = y * h / (90.0 * k)
    sigma = (k + 1.0) / 2.0 - xp.abs(y) / w
    st_pol = xp.where(y < 0, -1.0, 1.0) * (1.0 - sigma * sigma / k)
    lon_c = _hpx_facet_center(x, h, k, y < 0, xp)
    dx = (x - lon_c + 180.0) % 360.0 - 180.0
    lon_pol = lon_c + dx / xp.maximum(sigma, 1e-12)
    phi = xp.where(polar, lon_pol, x)
    st = xp.where(polar, st_pol, st_eq)
    theta = xp.arcsin(xp.clip(st, -1.0, 1.0)) * R2D
    return phi, theta


_RT2 = np.sqrt(0.5)


def _xph_gore_rotation(q, xp):
    """cos/sin of the gore->wing rotation angle chi = -135 + 90 q [deg],
    exactly (every chi is an odd multiple of 45 deg)."""
    c = xp.where((q == 1) | (q == 2), _RT2, -_RT2)
    s = xp.where(q >= 2, _RT2, -_RT2)
    return c, s


def _xph_native2xy(phi, theta, xp):
    """HEALPix polar butterfly (Calabretta & Lowe 2013, code XPH): the
    H=4, K=3 HEALPix gores re-hinged at the north pole.

    Construction (derived, not transcribed — see the module docstring for
    why the layout is uniquely pinned): longitude quadrant q holds
    lon in [-180+90q, -90+90q); within it the gore longitude is
    psi = lon - chi with chi = -135 + 90 q.  The gore is the H=4, K=3
    HEALPix strip for psi in [-45, 45] — equatorial belt
    (xi, eta) = (psi, 67.5 sin theta) for |sin theta| <= 2/3, Collignon
    caps xi = psi sigma, eta = sign(theta) (90 - 45 sigma) with
    sigma = sqrt(3 (1 - |sin theta|)) — translated so the north pole
    (eta = 90) sits at the origin and rotated by chi, which fans the four
    gores down the map diagonals into the butterfly.  Adjacent gores
    share their north-polar-cap edges continuously under exactly this
    chi assignment, and phi = 0 runs along -y as in every pole-centered
    projection.  Equal-area with the HPX Jacobian pi^2/4800 per deg^2
    (rotation and translation preserve area).
    """
    lon = (phi + 180.0) % 360.0 - 180.0
    q = xp.clip(xp.floor((lon + 180.0) / 90.0), 0.0, 3.0)
    chi = -135.0 + 90.0 * q
    psi = lon - chi
    st = xp.sin(theta * D2R)
    polar = xp.abs(st) > 2.0 / 3.0
    sigma = xp.sqrt(xp.maximum(3.0 * (1.0 - xp.abs(st)), 0.0))
    xi = xp.where(polar, psi * sigma, psi)
    eta = xp.where(polar,
                   xp.where(st < 0, -1.0, 1.0) * (90.0 - 45.0 * sigma),
                   67.5 * st)
    etap = eta - 90.0                       # north pole -> origin
    c, s = _xph_gore_rotation(q, xp)
    return xi * c - etap * s, xi * s + etap * c


def _xph_xy2native(x, y, xp):
    """XPH inverse: identify the wing from the map-plane quadrant (the
    wing axes lie on the diagonals), unrotate, untranslate, and invert
    the HEALPix gore equations (facet center at psi = 0)."""
    q = xp.where(y <= 0.0,
                 xp.where(x >= 0.0, 2.0, 1.0),
                 xp.where(x >= 0.0, 3.0, 0.0))
    chi = -135.0 + 90.0 * q
    c, s = _xph_gore_rotation(q, xp)
    xi = x * c + y * s
    eta = -x * s + y * c + 90.0
    polar_n = eta > 45.0
    polar_s = eta < -45.0
    sigma = xp.where(polar_n, (90.0 - eta) / 45.0, (90.0 + eta) / 45.0)
    sigma = xp.maximum(sigma, 0.0)
    st_pol = (1.0 - sigma * sigma / 3.0) * xp.where(polar_s, -1.0, 1.0)
    st = xp.where(polar_n | polar_s, st_pol, eta / 67.5)
    psi = xp.where(polar_n | polar_s, xi / xp.maximum(sigma, 1e-12), xi)
    theta = xp.arcsin(xp.clip(st, -1.0, 1.0)) * R2D
    return psi + chi, theta


# TSC face tables: (zeta, xi, eta) direction-cosine picks and face-center
# offsets, in the image-aligned frame e = cos(t)cos(p), f = cos(t)sin(p),
# n = sin(t).  Layout: equatorial band faces 1-4 at x = 0/90/180/270,
# north face above face 1, south face below it (Paper II fig. 4 unfold);
# continuity across every shared edge is asserted in the tests.
def _tsc_native2xy(phi, theta, xp):
    """Tangential spherical cube: gnomonic projection onto the 6 faces
    of the circumscribed cube (Calabretta & Greisen 2002 sect. 5.6.1)."""
    p, t = phi * D2R, theta * D2R
    n, ct = xp.sin(t), xp.cos(t)
    e, f = ct * xp.cos(p), ct * xp.sin(p)
    faces = ((n, f, -e, 0.0, 90.0),     # north
             (e, f, n, 0.0, 0.0),       # phi = 0
             (f, -e, n, 90.0, 0.0),     # phi = 90
             (-e, -f, n, 180.0, 0.0),   # phi = 180
             (-f, e, n, 270.0, 0.0),    # phi = 270
             (-n, f, e, 0.0, -90.0))    # south
    bz = bx = by = None
    for zeta, xi, eta, x0, y0 in faces:
        g = xp.where(xp.abs(zeta) > 1e-300, zeta, 1e-300)
        x = x0 + 45.0 * xi / g
        y = y0 + 45.0 * eta / g
        if bz is None:
            bz, bx, by = zeta, x, y
        else:
            better = zeta > bz
            bx = xp.where(better, x, bx)
            by = xp.where(better, y, by)
            bz = xp.where(better, zeta, bz)
    return bx, by


def _tsc_xy2native(x, y, xp):
    """TSC inverse: identify the face cell from (x, y) [x wrapped into
    (-45, 315]], rebuild the direction cosines, and normalize."""
    xw = (x + 45.0) % 360.0 - 45.0
    top = y > 45.0
    bot = y < -45.0
    fi = xp.clip(xp.floor((xw + 45.0) / 90.0), 0.0, 3.0)
    a_eq, b_eq = (xw - fi * 90.0) / 45.0, y / 45.0
    a_cap = xw / 45.0
    b_cap = xp.where(top, (y - 90.0) / 45.0, (y + 90.0) / 45.0)
    cap = top | bot
    a = xp.where(cap, a_cap, a_eq)
    b = xp.where(cap, b_cap, b_eq)
    inv = 1.0 / xp.sqrt(1.0 + a * a + b * b)
    ang = fi * (np.pi / 2.0)
    ca, sa = xp.cos(ang), xp.sin(ang)
    e = xp.where(top, -b * inv, xp.where(bot, b * inv, (ca - a * sa) * inv))
    f = xp.where(cap, a * inv, (sa + a * ca) * inv)
    n = xp.where(top, inv, xp.where(bot, -inv, b * inv))
    phi = xp.arctan2(f, e) * R2D
    theta = xp.arctan2(n, xp.sqrt(e * e + f * f)) * R2D
    return phi, theta


_SQRT2INV = 1.0 / np.sqrt(2.0)


def _qsc_uv_from_cosines(zeta, xi, eta, xp):
    """QSC in-face map: direction cosines (zeta toward the face center,
    xi/eta in-face) -> face-local (u, v) [deg in (-45, 45)].

    Exact closed form of the quadrilateralized spherical cube
    (Calabretta & Greisen 2002 sect. 5.6.4, after O'Neill & Laubscher
    1976).  For the sector |xi| >= |eta| with omega = eta/xi:

        u = sgn(xi) 45 sqrt((1 - zeta)/(1 - 1/sqrt(2 + omega^2)))
        v = (u/15) [atan(omega) - asin(omega/sqrt(2(1 + omega^2)))] R2D

    and the mirror sector swaps the roles of (u, xi) and (v, eta).  The
    projection is *exactly* equal-area (the Jacobian det d(x,y)/dOmega
    is the constant 3pi/8 everywhere — asserted in the tests), maps the
    cube edge |zeta| = |xi| to u = +-45 exactly, and its azimuthal part
    reproduces the equal-area sector construction computed by mpmath
    quadrature in the golden oracle (tests/generate_wcs_golden.py)."""
    ax, ae = xp.abs(xi), xp.abs(eta)
    amax = xp.maximum(ax, ae)
    amin = xp.minimum(ax, ae)
    om = amin / xp.maximum(amax, 1e-300)          # |omega| in [0, 1]
    core = 45.0 * xp.sqrt(xp.maximum(1.0 - zeta, 0.0)
                          / (1.0 - 1.0 / xp.sqrt(2.0 + om * om)))
    w = xp.arctan(om) - xp.arcsin(om / xp.sqrt(2.0 * (1.0 + om * om)))
    minor = core * w * R2D / 15.0
    xi_major = ax >= ae
    u = xp.sign(xi) * xp.where(xi_major, core, minor)
    v = xp.sign(eta) * xp.where(xi_major, minor, core)
    return u, v


def _qsc_cosines_from_uv(u, v, xp):
    """QSC inverse in-face map: face-local (u, v) -> direction cosines
    (zeta, xi, eta).  w = 15 min/max recovers omega through
    omega = sin(w)/(cos(w) - 1/sqrt(2)) (exact inverse of the closed
    form's azimuthal function; cos(15 deg) - 1/sqrt(2) > 0 keeps it
    finite on the whole face)."""
    au, av = xp.abs(u), xp.abs(v)
    amax = xp.maximum(au, av)
    amin = xp.minimum(au, av)
    w = (15.0 * D2R) * amin / xp.maximum(amax, 1e-300)
    om = xp.sin(w) / (xp.cos(w) - _SQRT2INV)      # in [0, 1]
    zeta = 1.0 - (amax / 45.0) ** 2 * (1.0 - 1.0 / xp.sqrt(2.0 + om * om))
    major = xp.sqrt(xp.maximum(1.0 - zeta * zeta, 0.0) / (1.0 + om * om))
    minor = om * major
    u_major = au >= av
    xi = xp.sign(u) * xp.where(u_major, major, minor)
    eta = xp.sign(v) * xp.where(u_major, minor, major)
    return zeta, xi, eta


def _qsc_native2xy(phi, theta, xp):
    """Quadrilateralized spherical cube: equal-area projection onto the 6
    cube faces; same face layout/orientation as TSC (Paper II fig. 4)."""
    p, t = phi * D2R, theta * D2R
    n, ct = xp.sin(t), xp.cos(t)
    e, f = ct * xp.cos(p), ct * xp.sin(p)
    faces = ((n, f, -e, 0.0, 90.0),     # north
             (e, f, n, 0.0, 0.0),       # phi = 0
             (f, -e, n, 90.0, 0.0),     # phi = 90
             (-e, -f, n, 180.0, 0.0),   # phi = 180
             (-f, e, n, 270.0, 0.0),    # phi = 270
             (-n, f, e, 0.0, -90.0))    # south
    bz = bx = by = None
    for zeta, xi, eta, x0, y0 in faces:
        u, v = _qsc_uv_from_cosines(zeta, xi, eta, xp)
        x = x0 + u
        y = y0 + v
        if bz is None:
            bz, bx, by = zeta, x, y
        else:
            better = zeta > bz
            bx = xp.where(better, x, bx)
            by = xp.where(better, y, by)
            bz = xp.where(better, zeta, bz)
    return bx, by


def _qsc_xy2native(x, y, xp):
    """QSC inverse: identify the face cell from (x, y) [x wrapped into
    (-45, 315]] exactly like TSC, rebuild the direction cosines with the
    closed-form inverse, and rotate out of the face frame."""
    xw = (x + 45.0) % 360.0 - 45.0
    top = y > 45.0
    bot = y < -45.0
    fi = xp.clip(xp.floor((xw + 45.0) / 90.0), 0.0, 3.0)
    u_eq, v_eq = xw - fi * 90.0, y
    u_cap = xw
    v_cap = xp.where(top, y - 90.0, y + 90.0)
    cap = top | bot
    u = xp.where(cap, u_cap, u_eq)
    v = xp.where(cap, v_cap, v_eq)
    zeta, xi, eta = _qsc_cosines_from_uv(u, v, xp)
    ang = fi * (np.pi / 2.0)
    ca, sa = xp.cos(ang), xp.sin(ang)
    # face bases (see _qsc_native2xy): north (zeta,xi,eta)=(n,f,-e),
    # south (-n,f,e), equatorial at phi0: zeta = e cos+f sin,
    # xi = -e sin + f cos, eta = n.
    e = xp.where(top, -eta, xp.where(bot, eta, zeta * ca - xi * sa))
    f = xp.where(cap, xi, zeta * sa + xi * ca)
    n = xp.where(top, zeta, xp.where(bot, -zeta, eta))
    phi = xp.arctan2(f, e) * R2D
    theta = xp.arcsin(xp.clip(n, -1.0, 1.0)) * R2D
    return phi, theta


def _theta_cot_theta(t, xp):
    """theta * cot(theta), smooth through theta = 0."""
    small = xp.abs(t) < 1e-4
    safe = xp.where(small, 1.0, t)
    return xp.where(small, 1.0 - t * t / 3.0,
                    safe * xp.cos(safe) / xp.sin(safe))


def _pco_theta_from_xy(xr, yr, xp):
    """PCO inverse latitude: the point lies on the parallel's arc
    xr^2 + (t + cot t - yr)^2 = cot^2 t.  Multiplying by t removes the
    pole at t = 0 without introducing a spurious root:
    g(t) = t (xr^2 + (t - yr)^2) + 2 (t cot t) (t - yr) = 0."""
    t = yr
    for _ in range(50):
        tc = _theta_cot_theta(t, xp)
        # d(t cot t)/dt, smooth through 0 (series: -2t/3 - 4t^3/45)
        small = xp.abs(t) < 1e-4
        safe = xp.where(small, 1.0, t)
        s = xp.sin(safe)
        dtc = xp.where(small, -2.0 * t / 3.0,
                       xp.cos(safe) / s - safe / (s * s))
        dy = t - yr
        g = t * (xr * xr + dy * dy) + 2.0 * tc * dy
        dg = xr * xr + dy * dy + 2.0 * t * dy + 2.0 * dtc * dy + 2.0 * tc
        t = t - g / xp.where(xp.abs(dg) > 1e-14, dg, 1e-14)
        t = xp.clip(t, -np.pi / 2 + 1e-12, np.pi / 2 - 1e-12)
    return t


def _mol_gamma_from_theta(theta, xp):
    """Solve 2g + sin 2g = pi sin(theta) by Newton iteration (Mollweide
    forward auxiliary angle; wcslib prjs2x MOL)."""
    t = theta * D2R
    target = np.pi * xp.sin(t)
    g = t  # good starting point; df >= 0 everywhere
    for _ in range(20):
        f = 2.0 * g + xp.sin(2.0 * g) - target
        df = 2.0 + 2.0 * xp.cos(2.0 * g)
        g = g - f / xp.maximum(df, 1e-9)
    # at the exact poles Newton stalls (df -> 0); the solution is +-pi/2
    g = xp.where(xp.abs(target) >= np.pi - 1e-14,
                 xp.sign(target) * (np.pi / 2.0), g)
    return g


def proj_xy2native(code: str, x, y, xp=np, pv=()):
    """(x, y) [deg] -> native (phi, theta) [deg]."""
    code = code.upper()
    if code == "AZP":
        return _azp_xy2native(x, y, xp, pv)
    if code == "SZP":
        return _szp_xy2native(x, y, xp, pv)
    if code == "HPX":
        return _hpx_xy2native(x, y, xp, pv)
    if code == "XPH":
        return _xph_xy2native(x, y, xp)
    if code == "TSC":
        return _tsc_xy2native(x, y, xp)
    if code == "QSC":
        return _qsc_xy2native(x, y, xp)
    if code == "SIN" and (_pv(pv, 1, 0.0) != 0.0 or _pv(pv, 2, 0.0) != 0.0):
        return _sin_xy2native(x, y, xp, pv)
    if code in _ZENITHAL:
        r = xp.sqrt(x * x + y * y)
        phi = xp.arctan2(x, -y) * R2D
        theta = _zenithal_r_to_theta(code, r, xp, pv=pv)
        return phi, theta
    if code in _CONIC:
        C, Rfn, Rinv, Y0 = _conic_params(code, pv, xp)
        ta = _pv(pv, 1, 0.0)
        sgn = 1.0 if ta >= 0 else -1.0
        dy = Y0 - y
        r = sgn * xp.sqrt(x * x + dy * dy)
        phi = xp.arctan2(x / r, dy / r) * R2D / C
        return phi, Rinv(r)
    if code in ("CAR", ""):
        return x, y
    if code == "CEA":
        lam = _pv(pv, 1, 1.0)
        theta = xp.arcsin(xp.clip(lam * y * D2R, -1.0, 1.0)) * R2D
        return x, theta
    if code == "MER":
        theta = 2.0 * xp.arctan(xp.exp(y * D2R)) * R2D - 90.0
        return x, theta
    if code == "MOL":
        g = xp.arcsin(xp.clip(y * D2R / np.sqrt(2.0), -1.0, 1.0))
        theta = xp.arcsin(
            xp.clip((2.0 * g + xp.sin(2.0 * g)) / np.pi, -1.0, 1.0)) * R2D
        cg = xp.cos(g)
        phi = np.pi * x / (2.0 * np.sqrt(2.0)) / xp.maximum(cg, 1e-12)
        return phi, theta
    if code in ("SFL", "GLS"):
        return x / xp.cos(y * D2R), y
    if code == "AIT":
        xr, yr = x * D2R, y * D2R
        z2 = 1.0 - (xr / 4.0) ** 2 - (yr / 2.0) ** 2
        z = xp.sqrt(xp.maximum(z2, 0.0))
        theta = xp.arcsin(xp.clip(yr * z, -1.0, 1.0)) * R2D
        phi = 2.0 * xp.arctan2(z * xr / 2.0, 2.0 * z2 - 1.0) * R2D
        return phi, theta
    if code == "CYP":
        mu = _pv(pv, 1, 1.0)
        lam = _pv(pv, 2, 1.0)
        eta = y * D2R / (mu + lam)
        theta = xp.arctan2(eta, xp.ones_like(eta)) + xp.arcsin(
            xp.clip(eta * mu / xp.sqrt(eta * eta + 1.0), -1.0, 1.0))
        return x / lam, theta * R2D
    if code == "PAR":
        s = xp.clip(y / 180.0, -1.0, 1.0)
        theta = 3.0 * xp.arcsin(s) * R2D
        return x / (1.0 - 4.0 * s * s), theta
    if code == "BON":
        t1 = _pv(pv, 1, 0.0)
        if t1 == 0.0:
            return x / xp.cos(y * D2R), y  # degenerates to SFL
        t1r = t1 * D2R
        c = 1.0 / np.tan(t1r) + t1r
        sgn = 1.0 if t1 > 0 else -1.0
        xr, dy = x * D2R, c - y * D2R
        rho = sgn * xp.sqrt(xr * xr + dy * dy)
        theta_r = c - rho
        E = xp.arctan2(xr / rho, dy / rho)
        phi = rho * E / xp.cos(theta_r)
        return phi * R2D, theta_r * R2D
    if code == "PCO":
        xr, yr = x * D2R, y * D2R
        t = _pco_theta_from_xy(xr, yr, xp)
        tc = _theta_cot_theta(t, xp)
        # E from the arc geometry; phi = E / sin(theta), -> x/theta->0
        small = xp.abs(t) < 1e-7
        safe = xp.where(small, 1.0, t)
        cot = tc / safe
        E = xp.arctan2(xr / cot, (safe + cot - yr) / cot)
        phi = xp.where(small, x, E / xp.sin(safe) * R2D)
        return phi, t * R2D
    raise ValueError(f"unsupported projection {code!r}")


def proj_native2xy(code: str, phi, theta, xp=np, pv=()):
    """native (phi, theta) [deg] -> (x, y) [deg]."""
    code = code.upper()
    if code == "AZP":
        return _azp_native2xy(phi, theta, xp, pv)
    if code == "SZP":
        return _szp_native2xy(phi, theta, xp, pv)
    if code == "HPX":
        return _hpx_native2xy(phi, theta, xp, pv)
    if code == "XPH":
        return _xph_native2xy(phi, theta, xp)
    if code == "TSC":
        return _tsc_native2xy(phi, theta, xp)
    if code == "QSC":
        return _qsc_native2xy(phi, theta, xp)
    if code == "SIN" and (_pv(pv, 1, 0.0) != 0.0 or _pv(pv, 2, 0.0) != 0.0):
        return _sin_native2xy(phi, theta, xp, pv)
    if code in _ZENITHAL:
        r = _zenithal_theta_to_r(code, theta, xp, pv=pv)
        p = phi * D2R
        return r * xp.sin(p), -r * xp.cos(p)
    if code in _CONIC:
        C, Rfn, _, Y0 = _conic_params(code, pv, xp)
        r = Rfn(theta)
        pc = C * phi * D2R
        return r * xp.sin(pc), -r * xp.cos(pc) + Y0
    if code in ("CAR", ""):
        return phi, theta
    if code == "CEA":
        lam = _pv(pv, 1, 1.0)
        return phi, R2D * xp.sin(theta * D2R) / lam
    if code == "MER":
        t = theta * D2R
        return phi, R2D * _precise_log(xp.tan((np.pi / 2.0 + t) / 2.0), xp)
    if code == "MOL":
        g = _mol_gamma_from_theta(theta, xp)
        x = 2.0 * np.sqrt(2.0) / np.pi * phi * xp.cos(g)
        y = np.sqrt(2.0) * R2D * xp.sin(g)
        return x, y
    if code in ("SFL", "GLS"):
        return phi * xp.cos(theta * D2R), theta
    if code == "AIT":
        p, t = phi * D2R / 2.0, theta * D2R
        gamma = xp.sqrt(2.0 / (1.0 + xp.cos(t) * xp.cos(p)))
        x = 2.0 * gamma * xp.cos(t) * xp.sin(p) * R2D
        y = gamma * xp.sin(t) * R2D
        return x, y
    if code == "CYP":
        mu = _pv(pv, 1, 1.0)
        lam = _pv(pv, 2, 1.0)
        t = theta * D2R
        return lam * phi, R2D * (mu + lam) * xp.sin(t) / (mu + xp.cos(t))
    if code == "PAR":
        t = theta * D2R
        return phi * (2.0 * xp.cos(2.0 * t / 3.0) - 1.0), \
            180.0 * xp.sin(t / 3.0)
    if code == "BON":
        t1 = _pv(pv, 1, 0.0)
        if t1 == 0.0:
            return phi * xp.cos(theta * D2R), theta  # degenerates to SFL
        t1r = t1 * D2R
        c = 1.0 / np.tan(t1r) + t1r
        t = theta * D2R
        rho = c - t
        E = phi * D2R * xp.cos(t) / rho
        return R2D * rho * xp.sin(E), R2D * (c - rho * xp.cos(E))
    if code == "PCO":
        t = theta * D2R
        tc = _theta_cot_theta(t, xp)
        small = xp.abs(t) < 1e-7
        safe = xp.where(small, 1.0, t)
        cot = tc / safe
        E = phi * D2R * xp.sin(safe)
        x = xp.where(small, phi, R2D * cot * xp.sin(E))
        sh = xp.sin(E / 2.0)
        y = xp.where(small, 0.0 * t,
                     R2D * (safe + cot * 2.0 * sh * sh))
        return x, y
    raise ValueError(f"unsupported projection {code!r}")


def celestial_pole(code: str, crval1: float, crval2: float,
                   lonpole: float | None, latpole: float | None, pv=()):
    """Compute celestial coordinates of the native pole (alpha_p, delta_p)
    and the native longitude of the celestial pole phi_p.

    Implements eq. 8-10 of Calabretta & Greisen (2002)."""
    phi0, theta0 = fiducial_native(code, pv)
    a0, d0 = crval1 * D2R, crval2 * D2R

    if lonpole is None:
        lonpole = 0.0 if crval2 >= theta0 else 180.0
    phip = lonpole * D2R
    if latpole is None:
        latpole = 90.0

    if theta0 == 90.0:
        # zenithal: pole at the reference point
        return crval1, crval2, lonpole

    t0 = theta0 * D2R
    dphi = phip - phi0 * D2R
    A = np.sin(t0)
    B = np.cos(t0) * np.cos(dphi)
    hyp = np.hypot(A, B)
    if hyp < 1e-12:
        # degenerate: delta_p unconstrained; use latpole
        dp = latpole * D2R
    else:
        gamma = np.arctan2(B, A)
        sarg = np.clip(np.sin(d0) / hyp, -1.0, 1.0)
        dp1 = np.arcsin(sarg) - gamma
        dp2 = np.pi - np.arcsin(sarg) - gamma
        # wrap into [-pi/2, pi/2+] range and pick solution nearest latpole
        cands = []
        for dpc in (dp1, dp2):
            if dpc > np.pi / 2 + 1e-12:
                dpc -= 2 * np.pi
            if dpc < -np.pi - 1e-12:
                dpc += 2 * np.pi
            if -np.pi / 2 - 1e-9 <= dpc <= np.pi / 2 + 1e-9:
                cands.append(dpc)
        if not cands:
            raise ValueError("no valid native pole solution")
        dp = min(cands, key=lambda v: abs(v - latpole * D2R))

    # alpha_p (eq. 9-10); the dp = +-90 degenerate cases carry the
    # Paper II phase terms — 'ap = a0' alone put every longitude 180 deg
    # off for cylindrical/conic projections with crval2 at the fiducial
    # latitude (the standard all-sky / galactic-plane setup)
    if abs(np.cos(dp)) < 1e-12:
        if dp > 0:
            ap = a0 + phip - phi0 * D2R - np.pi
        else:
            ap = a0 - phip + phi0 * D2R
    elif abs(d0 - np.pi / 2) < 1e-12:
        ap = a0
    else:
        sin_dphi = np.sin(dphi) * np.cos(t0) / np.cos(d0)
        cos_dphi = (np.sin(t0) - np.sin(dp) * np.sin(d0)) / (np.cos(dp) *
                                                             np.cos(d0))
        ap = a0 - np.arctan2(sin_dphi, cos_dphi)

    return ap * R2D, dp * R2D, lonpole


# The native<->celestial rotation is an involutive orthogonal map
#   x' = -sin(dp) x + cos(dp) z ;  y' = -y ;  z' = cos(dp) x + sin(dp) z
# applied between longitude-relative frames.  Using atan2(z, hypot(x, y))
# for the latitude keeps the transform well-conditioned near the poles
# (a naive arcsin(sin_lat) formulation loses half the float64 digits there).
def _rotate_pole(lon_rel, lat, delta_p, xp):
    dp = delta_p * D2R
    sdp, cdp = np.sin(dp), np.cos(dp)
    cl = xp.cos(lat * D2R)
    x = cl * xp.cos(lon_rel * D2R)
    y = cl * xp.sin(lon_rel * D2R)
    z = xp.sin(lat * D2R)
    xo = -sdp * x + cdp * z
    yo = -y
    zo = cdp * x + sdp * z
    lon_out = xp.arctan2(yo, xo) * R2D
    lat_out = xp.arctan2(zo, xp.sqrt(xo * xo + yo * yo)) * R2D
    return lon_out, lat_out


def native_to_celestial(phi, theta, alpha_p, delta_p, phi_p, xp=np):
    """Rotate native (phi, theta) to celestial (alpha, delta), all degrees."""
    da, delta = _rotate_pole(phi - phi_p, theta, delta_p, xp)
    return (alpha_p + da) % 360.0, delta


def celestial_to_native(alpha, delta, alpha_p, delta_p, phi_p, xp=np):
    """Rotate celestial (alpha, delta) to native (phi, theta), all degrees."""
    dphi, theta = _rotate_pole(alpha - alpha_p, delta, delta_p, xp)
    phi = (dphi + phi_p + 180.0) % 360.0 - 180.0
    return phi, theta
