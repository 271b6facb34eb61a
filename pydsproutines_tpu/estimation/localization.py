"""Localization: Doppler geometry, TDOA/FDOA/RTT grid searches, CRBs.

Reference semantics: /root/reference/localizationRoutines.py
(calculateRangeRate :90, calculateDoppler :122, gridSearchRTT :439,
gridSearchTDOA :510, gridSearchFDOA :552, gridSearchTDOA_direct :620,
gridSearchTDFD_direct :661, latlongrid_to_ecef :752, calcCRB_TD :814,
calcCRB_TDFD :850, projectCRBtoEllipse :933).

Design: grid searches are "vmap paradise" (SURVEY.md §7.8) — the
cost over (num_grid x num_measurements) is one broadcasted jax expression in a
single jit, instead of the reference's per-measurement python loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

LIGHTSPEED = 299792458.0


# ---------------------------------------------------------------------------
# Doppler geometry
# ---------------------------------------------------------------------------

def calculate_range_rate(tx_x, rx_x, tx_xdot=None, rx_xdot=None):
    """Range rate along the tx->rx direction (reference calculateRangeRate).
    Accepts single vectors or Nx3 rows for the positions."""
    tx_x = jnp.asarray(tx_x, dtype=jnp.float64)
    rx_x = jnp.asarray(rx_x, dtype=jnp.float64)
    tx_xdot = jnp.zeros(3) if tx_xdot is None else jnp.asarray(tx_xdot)
    rx_xdot = jnp.zeros(3) if rx_xdot is None else jnp.asarray(rx_xdot)
    dirvec = jnp.atleast_2d(rx_x - tx_x)
    dirvec = dirvec / jnp.linalg.norm(dirvec, axis=1, keepdims=True)
    return dirvec @ rx_xdot - dirvec @ tx_xdot


def calculate_doppler(f0, tx_x, rx_x, tx_xdot=None, rx_xdot=None,
                      lightspd: float = LIGHTSPEED):
    """Doppler shift = -range_rate/c * f0 (reference calculateDoppler)."""
    rdot = calculate_range_rate(tx_x, rx_x, tx_xdot, rx_xdot)
    return -rdot / lightspd * f0


# ---------------------------------------------------------------------------
# Grid searches
# ---------------------------------------------------------------------------

def _flat_mesh(xrange, yrange, z):
    xm, ym = np.meshgrid(np.asarray(xrange), np.asarray(yrange))
    return np.vstack((xm.flatten(), ym.flatten(),
                      np.full(xm.size, z))).T.astype(np.float32)


@jax.jit
def _tdoa_cost(gridmat, s1x, s2x, r, r_sigma):
    """Sum over measurements of ((r - rm)/sigma)^2 on every grid point.
    gridmat (G,3); s1x/s2x (M,3); r/r_sigma (M,)."""
    rm = (jnp.linalg.norm(s2x[:, None, :] - gridmat[None, :, :], axis=-1)
          - jnp.linalg.norm(s1x[:, None, :] - gridmat[None, :, :], axis=-1))
    cost = ((r[:, None] - rm) / r_sigma[:, None]) ** 2
    return jnp.sum(cost, axis=0)


@jax.jit
def _fdoa_cost(gridmat, s1x, s2x, s1v, s2v, drdt, drdt_sigma):
    d1 = gridmat[None, :, :] - s1x[:, None, :]
    d2 = gridmat[None, :, :] - s2x[:, None, :]
    d1 = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    parv1 = jnp.sum(d1 * s1v[:, None, :], axis=-1)
    parv2 = jnp.sum(d2 * s2v[:, None, :], axis=-1)
    vmdiff = parv2 - parv1
    cost = ((drdt[:, None] - vmdiff) / drdt_sigma[:, None]) ** 2
    return jnp.sum(cost, axis=0)


def grid_search_tdoa_direct(s1x_list, s2x_list, tdoa_list, td_sigma_list,
                            gridmat) -> jnp.ndarray:
    """TDOA cost over an explicit (N, 3) grid (reference
    gridSearchTDOA_direct, localizationRoutines.py:620)."""
    s1x = jnp.asarray(np.asarray(s1x_list), dtype=jnp.float32).reshape(-1, 3)
    s2x = jnp.asarray(np.asarray(s2x_list), dtype=jnp.float32).reshape(-1, 3)
    r = jnp.asarray(np.asarray(tdoa_list) * LIGHTSPEED, dtype=jnp.float32)
    rs = jnp.asarray(np.asarray(td_sigma_list) * LIGHTSPEED, dtype=jnp.float32)
    return _tdoa_cost(jnp.asarray(gridmat, dtype=jnp.float32), s1x, s2x, r, rs)


def grid_search_tdoa(s1x_list, s2x_list, tdoa_list, td_sigma_list, xrange,
                     yrange, z) -> jnp.ndarray:
    """TDOA grid search over a flat surface at height z (reference
    gridSearchTDOA, localizationRoutines.py:510)."""
    gridmat = _flat_mesh(xrange, yrange, z)
    return grid_search_tdoa_direct(s1x_list, s2x_list, tdoa_list,
                                   td_sigma_list, gridmat)


def grid_search_fdoa(s1x_list, s2x_list, s1v_list, s2v_list, fdoa_list,
                     fd_sigma_list, xrange, yrange, z, fc) -> jnp.ndarray:
    """FDOA grid search over a flat surface (reference gridSearchFDOA,
    localizationRoutines.py:552)."""
    gridmat = jnp.asarray(_flat_mesh(xrange, yrange, z))
    s1x = jnp.asarray(np.asarray(s1x_list), dtype=jnp.float32).reshape(-1, 3)
    s2x = jnp.asarray(np.asarray(s2x_list), dtype=jnp.float32).reshape(-1, 3)
    s1v = jnp.asarray(np.asarray(s1v_list), dtype=jnp.float32).reshape(-1, 3)
    s2v = jnp.asarray(np.asarray(s2v_list), dtype=jnp.float32).reshape(-1, 3)
    drdt = jnp.asarray(np.asarray(fdoa_list) / fc * LIGHTSPEED, jnp.float32)
    drdt_sigma = jnp.asarray(np.asarray(fd_sigma_list) / fc * LIGHTSPEED,
                             jnp.float32)
    return _fdoa_cost(gridmat, s1x, s2x, s1v, s2v, drdt, drdt_sigma)


def grid_search_tdfd_direct(s1x_list, s2x_list, tdoa_list, td_sigma_list,
                            s1v_list, s2v_list, fdoa_list, fd_sigma_list, fc,
                            gridmat) -> jnp.ndarray:
    """Joint TDOA+FDOA cost over an explicit grid (reference
    gridSearchTDFD_direct, localizationRoutines.py:661)."""
    td = grid_search_tdoa_direct(s1x_list, s2x_list, tdoa_list,
                                 td_sigma_list, gridmat)
    fd = _fdoa_cost(
        jnp.asarray(gridmat, dtype=jnp.float32),
        jnp.asarray(np.asarray(s1x_list), jnp.float32).reshape(-1, 3),
        jnp.asarray(np.asarray(s2x_list), jnp.float32).reshape(-1, 3),
        jnp.asarray(np.asarray(s1v_list), jnp.float32).reshape(-1, 3),
        jnp.asarray(np.asarray(s2v_list), jnp.float32).reshape(-1, 3),
        jnp.asarray(np.asarray(fdoa_list) / fc * LIGHTSPEED, jnp.float32),
        jnp.asarray(np.asarray(fd_sigma_list) / fc * LIGHTSPEED, jnp.float32))
    return td + fd


def grid_search_rtt(t_list, r_list, toa_list, toa_sigma_list,
                    grid_list) -> jnp.ndarray:
    """One-bounce RTT grid search (reference gridSearchRTT,
    localizationRoutines.py:439)."""
    toa = np.asarray(toa_list)
    n = toa.size
    t_arr = np.asarray(t_list, dtype=np.float64)
    r_arr = np.asarray(r_list, dtype=np.float64)
    if t_arr.ndim == 1:
        t_arr = np.tile(t_arr, (n, 1))
    if r_arr.ndim == 1:
        r_arr = np.tile(r_arr, (n, 1))
    grid = jnp.asarray(grid_list, dtype=jnp.float64)
    td = jnp.asarray(t_arr)
    rd = jnp.asarray(r_arr)
    m_dist = jnp.asarray(toa * LIGHTSPEED)
    m_err = jnp.asarray(np.asarray(toa_sigma_list) * LIGHTSPEED)
    e_dist = (jnp.linalg.norm(td[:, None, :] - grid[None, :, :], axis=-1)
              + jnp.linalg.norm(rd[:, None, :] - grid[None, :, :], axis=-1))
    cost = (e_dist - m_dist[:, None]) ** 2 / (m_err[:, None] ** 2)
    return jnp.sum(cost, axis=0)


def latlongrid_to_ecef(centrelat: float, centrelon: float, latspan: float,
                       lonspan: float, num_lat: int, num_lon: int):
    """Lat/lon grid around a centre point, converted to ECEF (N, 3)
    (reference latlongrid_to_ecef, localizationRoutines.py:752)."""
    from pydsproutines_tpu.estimation.coords import geodetic_lla_to_ecef

    lonlist = np.linspace(centrelon - lonspan / 2, centrelon + lonspan / 2,
                          num_lon)
    latlist = np.linspace(centrelat - latspan / 2, centrelat + latspan / 2,
                          num_lat)
    longrid, latgrid = np.meshgrid(lonlist, latlist)
    ecef = geodetic_lla_to_ecef(np.radians(latgrid.flatten()),
                                np.radians(longrid.flatten()), 0.0).T
    return ecef, lonlist, latlist


# ---------------------------------------------------------------------------
# CRBs (small matrices — host numpy, as reference)
# ---------------------------------------------------------------------------

def calc_crb_td(x, s, sig_r, pairs=None, cmat=None):
    """TDOA CRB; s is 3xN column-wise sensors (reference calcCRB_TD,
    localizationRoutines.py:814). Returns (crb, fim)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
    s = np.asarray(s, dtype=np.float64)
    m = s.shape[1]
    r = np.linalg.norm(x - s, axis=0)
    r_dx = (x - s) / r
    if pairs is None:
        pairs = np.arange(m).reshape(-1, 2)
    rmat = np.stack([r_dx[:, p0] - r_dx[:, p1] for p0, p1 in pairs], axis=1)
    sigr = np.diag(np.asarray(sig_r) ** -2.0)
    fim = rmat @ sigr @ rmat.T
    if cmat is None:
        crb = np.linalg.inv(fim)
    else:
        u = scipy.linalg.null_space(np.asarray(cmat).T)
        crb = u @ np.linalg.inv(u.T @ fim @ u) @ u.T
    return crb, fim


def calc_crb_tdfd(x, s, sig_r, xdot, sdot, sig_r_dot, pairs=None, cmat=None):
    """Joint TDOA+FDOA CRB over (position, velocity) (reference calcCRB_TDFD,
    localizationRoutines.py:850)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
    xdot = np.asarray(xdot, dtype=np.float64).reshape(-1, 1)
    s = np.asarray(s, dtype=np.float64)
    sdot = np.asarray(sdot, dtype=np.float64)
    m = s.shape[1]
    r = np.linalg.norm(x - s, axis=0)
    r_dx = (x - s) / r
    rdot = np.sum((xdot - sdot) * (x - s), axis=0) / r
    r_dxdot = np.zeros((3, m))
    rdot_dx = (-r_dx * rdot + xdot - sdot) / r
    rdot_dxdot = (x - s) / r
    if pairs is None:
        pairs = np.arange(m).reshape(-1, 2)
    npairs = len(pairs)
    rmat = np.zeros((6, npairs))
    rdotmat = np.zeros((6, npairs))
    for k, (c1, c2) in enumerate(pairs):
        rmat[0:3, k] = r_dx[:, c1] - r_dx[:, c2]
        rmat[3:6, k] = r_dxdot[:, c1] - r_dxdot[:, c2]
        rdotmat[0:3, k] = rdot_dx[:, c1] - rdot_dx[:, c2]
        rdotmat[3:6, k] = rdot_dxdot[:, c1] - rdot_dxdot[:, c2]
    sigr = np.diag(np.asarray(sig_r) ** -2.0)
    sigrdot = np.diag(np.asarray(sig_r_dot) ** -2.0)
    fim = rmat @ sigr @ rmat.T + rdotmat @ sigrdot @ rdotmat.T
    if cmat is None:
        return np.linalg.inv(fim)
    u = scipy.linalg.null_space(np.asarray(cmat).T)
    return u @ np.linalg.inv(u.T @ fim @ u) @ u.T


def project_crb_to_ellipse(crb, pos, percent, dof: int = 2, theta=None):
    """Project a CRB covariance onto a chi-square confidence ellipse in 3-D
    (reference projectCRBtoEllipse, localizationRoutines.py:933)."""
    from scipy.stats.distributions import chi2

    pos = np.asarray(pos, dtype=np.float64).reshape(-1, 1)
    sigval = chi2.ppf(percent, df=dof)
    u, sv, vh = np.linalg.svd(np.asarray(crb))
    a = sv[0] ** 0.5
    b = sv[1] ** 0.5
    if theta is None:
        theta = np.arange(0, 2 * np.pi, 0.01)
    r = (sigval ** 0.5 * a * b
         / np.sqrt(b ** 2 * np.cos(theta) ** 2 + a ** 2 * np.sin(theta) ** 2))
    x = np.repeat((r * np.cos(theta))[None, :], 3, axis=0)
    y = np.repeat((r * np.sin(theta))[None, :], 3, axis=0)
    return x * u[:, 0:1] + y * u[:, 1:2] + pos


# ---------------------------------------------------------------------------
# Hyperbola tracing (reference localizationRoutines.py:150-365)
# ---------------------------------------------------------------------------

def range_difference_of_arrival(x, s1, s2):
    """roa(x, s2) - roa(x, s1) (reference rangeDifferenceOfArrival,
    localizationRoutines.py:168)."""
    x = np.asarray(x, dtype=np.float64)
    return (np.linalg.norm(x - np.asarray(s2, np.float64), axis=-1)
            - np.linalg.norm(x - np.asarray(s1, np.float64), axis=-1))


def hyperboloid_gradient(x, s1, s2, rangediff):
    """Gradient of (rdoa(x) - rangediff)^2 (reference hyperboloidGradient,
    localizationRoutines.py:187)."""
    x = np.asarray(x, dtype=np.float64)
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    g2 = (x - s2) / np.linalg.norm(x - s2, axis=-1, keepdims=True)
    g1 = (x - s1) / np.linalg.norm(x - s1, axis=-1, keepdims=True)
    err = (range_difference_of_arrival(x, s1, s2) - rangediff)
    return 2.0 * np.expand_dims(err, -1) * (g2 - g1)


def hyperbola_grad_desc(pt, s1, s2, rangediff,
                        surface_norm=(0.0, 0.0, 1.0), iters: int = 30):
    """Project ``pt`` back onto the TDOA hyperbola within the plane normal to
    ``surface_norm`` (reference hyperbolaGradDesc, localizationRoutines.py:198
    — scipy line-minimization there; here a fixed-iteration Newton root-find
    along the projected gradient, which vectorizes over many points).
    """
    pt = np.asarray(pt, dtype=np.float64).copy()
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    nrm = np.asarray(surface_norm, np.float64)
    nrm = nrm / np.linalg.norm(nrm)
    g = hyperboloid_gradient(pt, s1, s2, rangediff)
    g = g - np.expand_dims(np.sum(g * nrm, axis=-1), -1) * nrm
    gn = np.linalg.norm(g, axis=-1, keepdims=True)
    g = np.where(gn > 0, g / np.where(gn == 0, 1.0, gn), g)
    delta = np.zeros(np.shape(pt)[:-1])
    for _ in range(iters):
        p = pt + np.expand_dims(delta, -1) * g
        h = range_difference_of_arrival(p, s1, s2) - rangediff
        # dh/ddelta = g . (unit(p - s2) - unit(p - s1))
        u2 = (p - s2) / np.linalg.norm(p - s2, axis=-1, keepdims=True)
        u1 = (p - s1) / np.linalg.norm(p - s1, axis=-1, keepdims=True)
        dh = np.sum(g * (u2 - u1), axis=-1)
        delta = delta - h / np.where(np.abs(dh) < 1e-12, 1e-12, dh)
    return pt + np.expand_dims(delta, -1) * g


def hyperbola_tangent_xy(pt, s1, s2, rangediff):
    """Unit tangent to the hyperbola in the XY plane (reference
    hyperbolaTangentXY, localizationRoutines.py:256)."""
    g = hyperboloid_gradient(pt, s1, s2, rangediff)
    if g[1] == 0.0:
        h = np.array([0.0, 1.0, 0.0])
    else:
        h = np.array([1.0, -g[0] / g[1], 0.0])
    return h / np.linalg.norm(h)


def generate_hyperbola_xy(half_num_pts: int, rangediff: float, s1, s2,
                          z: float = 0.0, startpt=None,
                          orthostep: float = 0.1) -> np.ndarray:
    """Trace the TDOA hyperbola in the plane at height ``z``: tangent step +
    Newton descent back onto the curve, both directions from the start point
    (reference generateHyperbolaXY, localizationRoutines.py:274). Returns a
    (2*half_num_pts + 1, 3) array of points in curve order."""
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    if startpt is None:
        startpt = (s1 + s2) / 2.0
        startpt = np.array([startpt[0], startpt[1], z])
    startpt = hyperbola_grad_desc(startpt, s1, s2, rangediff)
    out = np.zeros((2 * half_num_pts + 1, 3))
    out[half_num_pts] = startpt
    h1 = hyperbola_tangent_xy(startpt, s1, s2, rangediff)
    for sign, direction in ((-1, h1), (+1, -h1)):
        h = direction
        pt = startpt
        for i in range(half_num_pts):
            oldpt = pt
            pt = hyperbola_grad_desc(pt + h * orthostep, s1, s2, rangediff)
            out[half_num_pts + sign * (i + 1)] = pt
            hnew = pt - oldpt
            h = hnew / np.linalg.norm(hnew)
    return out


# ---------------------------------------------------------------------------
# Blind linear RTT (reference localizationRoutines.py:368, :899)
# ---------------------------------------------------------------------------

@jax.jit
def _blind_rtt_cost(grid, tx, rx, proj, d_obs):
    """cost[g] = || P (toa - gamma_g) ||^2 where P annihilates the linear
    clock model A = [t, 1] — the vectorized form of the reference's per-point
    lstsq residual (localizationRoutines.py:421-434)."""
    t_tx = jnp.linalg.norm(tx[:, None, :] - grid[None, :, :], axis=-1)
    t_rx = jnp.linalg.norm(rx[:, None, :] - grid[None, :, :], axis=-1)
    gamma = (t_tx + t_rx) / LIGHTSPEED            # (M, G)
    d = d_obs[:, None] - gamma                    # (M, G)
    resid = proj @ d                              # (M, G)
    return jnp.sum(resid * resid, axis=0)


def grid_search_blind_linear_rtt(tx_list, rx_list, time_list, toa_list,
                                 toa_sigma_list, grid_list) -> jnp.ndarray:
    """RTT localization with an unknown linear clock drift: for each grid
    point, fit d = toa - gamma(x) to a + b*t by least squares and score the
    residual (reference gridSearchBlindLinearRTT, localizationRoutines.py:368,
    vectorized over the whole grid instead of per-point lstsq)."""
    toa = np.asarray(toa_list, np.float64)
    n = toa.size
    tx = np.asarray(tx_list, np.float64)
    rx = np.asarray(rx_list, np.float64)
    if tx.ndim == 1:
        tx = np.tile(tx, (n, 1))
    if rx.ndim == 1:
        rx = np.tile(rx, (n, 1))
    t = np.asarray(time_list, np.float64).reshape(-1)
    a = np.stack([t, np.ones_like(t)], axis=1)             # (M, 2)
    proj = np.eye(n) - a @ np.linalg.pinv(a)               # residual maker
    del toa_sigma_list  # reference computes unweighted lstsq residuals
    return _blind_rtt_cost(jnp.asarray(grid_list, jnp.float64),
                           jnp.asarray(tx), jnp.asarray(rx),
                           jnp.asarray(proj), jnp.asarray(toa))


def calc_crb_blind_linear_rtt(x, s, p, t, sig_r, cmat=None):
    """CRB for blind-linear RTT: unknowns (x, drift slope, offset)
    (reference calcCRB_BlindLinearRTT, localizationRoutines.py:899).
    ``s``/``p`` are 3 x N transmit/receive sensor positions."""
    x = np.asarray(x, np.float64).reshape(-1, 1)
    s = np.asarray(s, np.float64)
    p = np.asarray(p, np.float64)
    if p.ndim == 1:
        p = p.reshape(-1, 1)
    m = s.shape[1]
    r_s = np.linalg.norm(x - s, axis=0)
    r_p = np.linalg.norm(x - p, axis=0)
    r_dx = (x - s) / r_s + (x - p) / r_p
    r = np.zeros((5, m))
    r[0:3] = r_dx
    r[3] = np.asarray(t, np.float64)
    r[4] = 1.0
    sigr = np.diag(np.asarray(sig_r, np.float64) ** -2.0)
    fim = r @ sigr @ r.T
    if cmat is None:
        return np.linalg.inv(fim)
    import scipy.linalg as sla
    u = sla.null_space(np.asarray(cmat, np.float64).T)
    return u @ np.linalg.inv(u.T @ fim @ u) @ u.T


# ---------------------------------------------------------------------------
# OO grid localizers (reference localizationRoutines.py:960-1180)
# ---------------------------------------------------------------------------

class GridLocalizer:
    """Grid-search localizer over an explicit (N, 3) point matrix; combine
    with a measurement mixin for run() (reference GridLocalizer,
    localizationRoutines.py:960)."""

    def __init__(self, gridmat, xrange, yrange):
        self.gridmat = np.asarray(gridmat, np.float64)
        self.xrange = np.asarray(xrange)
        self.yrange = np.asarray(yrange)

    @classmethod
    def from_xy_meshgrid(cls, xrange, yrange, z: float = 0.0):
        return cls(_flat_mesh(xrange, yrange, z), xrange, yrange)

    def run(self, *args, **kwargs):
        raise NotImplementedError("combine with a measurement mixin")

    def localize(self, cost_grid):
        return self.gridmat[int(np.argmin(np.asarray(cost_grid)))]

    def crb(self, *args, **kwargs):
        raise NotImplementedError("combine with a measurement mixin")

    def plot(self, cost_grid, ax=None):
        """Likelihood heatmap exp(-cost/2) over the grid (matplotlib; the
        reference plots via pyqtgraph)."""
        import matplotlib.pyplot as plt
        if ax is None:
            _, ax = plt.subplots()
        img = np.exp(-0.5 * np.asarray(cost_grid).reshape(
            self.yrange.size, self.xrange.size))
        h = ax.imshow(img, origin="lower", aspect="auto",
                      extent=(float(self.xrange[0]), float(self.xrange[-1]),
                              float(self.yrange[0]), float(self.yrange[-1])))
        return ax, h


class LatLonGridLocalizer(GridLocalizer):
    """Geodetic-grid localizer: search runs in ECEF, answers in lat/lon
    (reference LatLonGridLocalizer, localizationRoutines.py:1032)."""

    def __init__(self, latlist, lonlist, gridmat):
        super().__init__(gridmat, lonlist, latlist)
        self.latlist = np.asarray(latlist)
        self.lonlist = np.asarray(lonlist)

    @classmethod
    def from_latlon_limits(cls, centrelat, centrelon, latspan, lonspan,
                           num_lat, num_lon):
        ecef, lonlist, latlist = latlongrid_to_ecef(
            centrelat, centrelon, latspan, lonspan, num_lat, num_lon)
        return cls(latlist, lonlist, ecef)

    def localize(self, cost_grid):
        idx = int(np.argmin(np.asarray(cost_grid)))
        # gridmat rows are ordered lat-major (latlongrid_to_ecef meshgrid)
        lat = self.latlist[idx // self.lonlist.size]
        lon = self.lonlist[idx % self.lonlist.size]
        return lon, lat, self.gridmat[idx]


class TDMixin:
    """TDOA weighted-least-squares cost over the grid (reference TDMixin,
    localizationRoutines.py:1072)."""

    def run(self, s1x_list, s2x_list, tdoa_list, td_sigma_list):
        s1 = np.asarray(s1x_list).reshape(-1, 3)
        s2 = np.asarray(s2x_list).reshape(-1, 3)
        return grid_search_tdoa_direct(s1, s2, tdoa_list, td_sigma_list,
                                       self.gridmat)

    def crb(self, x, s, sig_r, **kwargs):
        return calc_crb_td(x, s, sig_r, **kwargs)


class TDFDMixin:
    """Joint TDOA+FDOA cost over the grid (reference TDFDMixin,
    localizationRoutines.py:1110)."""

    def run(self, s1x_list, s2x_list, tdoa_list, td_sigma_list, s1v_list,
            s2v_list, fdoa_list, fd_sigma_list, fc):
        return grid_search_tdfd_direct(
            np.asarray(s1x_list).reshape(-1, 3),
            np.asarray(s2x_list).reshape(-1, 3), tdoa_list, td_sigma_list,
            np.asarray(s1v_list).reshape(-1, 3),
            np.asarray(s2v_list).reshape(-1, 3), fdoa_list, fd_sigma_list,
            fc, self.gridmat)

    def crb(self, x, s, sig_r, xdot, sdot, sig_r_dot, **kwargs):
        return calc_crb_tdfd(x, s, sig_r, xdot, sdot, sig_r_dot, **kwargs)


class BlindLinearRTTMixin:
    """Blind linear-clock RTT cost over the grid."""

    def run(self, tx_list, rx_list, time_list, toa_list, toa_sigma_list):
        return grid_search_blind_linear_rtt(tx_list, rx_list, time_list,
                                            toa_list, toa_sigma_list,
                                            self.gridmat)

    def crb(self, x, s, p, t, sig_r, **kwargs):
        return calc_crb_blind_linear_rtt(x, s, p, t, sig_r, **kwargs)


class TDOAGridLocalizer(TDMixin, GridLocalizer):
    pass


class TDFDGridLocalizer(TDFDMixin, GridLocalizer):
    pass


class TDOALatLonGridLocalizer(TDMixin, LatLonGridLocalizer):
    pass


class TDFDLatLonGridLocalizer(TDFDMixin, LatLonGridLocalizer):
    pass
