"""MUSIC / CAPON / ESPRIT subspace frequency estimation.

Reference semantics: /root/reference/musicRoutines.py (musicAlg :17,
CovarianceTechnique :187, MUSIC :349, CAPON :471, ESPRIT :500).

Implementation note: these are small-matrix (rows ~ 100) estimators. The
standalone MUSIC/CAPON/ESPRIT classes are host numpy (they run alongside the
device pipeline on short snapshots — the reference layers it the same way:
musicXcorr, xcorrRoutines.py:378, downsamples first). The throughput path,
``music_xcorr_device``, runs fully on device: batched covariances, a vmapped
Hermitian eigh, and the
pseudospectrum products, with only the final grids fetched to host.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps


def snapshot_matrix(x, rows: int, snapshot_jump: int | None = None) -> np.ndarray:
    """Arrange 1-d ``x`` (or a dict of 1-d arrays) into a (rows, cols)
    snapshot matrix (reference musicAlg matrix assembly, musicRoutines.py:66-118).

    snapshot_jump=None: disjoint columns via reshape. Otherwise columns are
    sliding windows advancing by ``snapshot_jump`` samples.
    """
    if isinstance(x, dict):
        mats = [snapshot_matrix(xi, rows, snapshot_jump) for xi in x.values()]
        return np.hstack(mats)
    x = np.asarray(x).flatten()
    if snapshot_jump is None:
        cols = len(x) // rows
        return x[: rows * cols].reshape(cols, rows).T
    if snapshot_jump <= 0:
        raise ValueError("snapshot_jump must be at least 1.")
    cols = (x.size - rows) // snapshot_jump + 1
    idx = np.arange(rows)[:, None] + snapshot_jump * np.arange(cols)[None, :]
    return x[idx]


def covariance(x, rows: int, snapshot_jump: int | None = None,
               fwd_bwd: bool = False, avg_to_toeplitz: bool = False,
               use_autocorr: bool = False) -> np.ndarray:
    """Covariance estimate with optional forward-backward correction,
    Toeplitz diagonal averaging, or the autocorrelation method (reference
    musicAlg, musicRoutines.py:55-135)."""
    if use_autocorr:
        x = np.asarray(x).flatten()
        autocorr = sps.correlate(x, x)
        import scipy.linalg as sla
        return sla.toeplitz(
            autocorr[len(x) - 1: len(x) - 1 + rows] / (len(x) - np.arange(rows)))

    xs = snapshot_matrix(x, rows, snapshot_jump)
    cols = xs.shape[1]
    rx = (1.0 / cols) * xs @ xs.conj().T
    if fwd_bwd:
        j = np.eye(rx.shape[0])[:, ::-1]
        rx = 0.5 * (rx + j @ rx.T @ j)
    if avg_to_toeplitz:
        rx_tp = np.zeros_like(rx)
        for k in range(-rx.shape[0] + 1, rx.shape[1]):
            d = np.mean(np.diag(rx, k))
            rx_tp += np.diag(np.full(rx.shape[0] - abs(k), d), k)
        rx = rx_tp
    return rx


def _pseudospectrum(u, s, freqlist, rows, p, use_signal_as_numerator):
    ehlist = np.exp(-2j * np.pi * np.asarray(freqlist).reshape(-1, 1)
                    * np.arange(rows))
    d = ehlist @ u[:, p:]
    denom = np.sum(np.abs(d) ** 2, axis=1)
    numerator = 1.0
    if use_signal_as_numerator:
        ssp = s[:p] ** -0.5
        siginv = u[:, :p] * ssp
        n = ehlist @ siginv
        numerator = np.sum(np.abs(n) ** 2, axis=1)
    return numerator / denom


def music_alg(x, freqlist, rows: int, plist, snapshot_jump=None,
              fwd_bwd: bool = False, use_signal_as_numerator: bool = False,
              avg_to_toeplitz: bool = False, use_autocorr: bool = False):
    """MUSIC pseudospectrum over ``freqlist`` (normalized to [-1, 1]) for each
    signal-subspace dimension in ``plist`` (reference musicAlg,
    musicRoutines.py:17). Returns (f, u, s, vh)."""
    freqlist = np.asarray(freqlist)
    if not np.all(np.abs(freqlist) <= 1.0):
        raise ValueError("Frequency list input must be normalized.")
    rx = covariance(x, rows, snapshot_jump, fwd_bwd, avg_to_toeplitz,
                    use_autocorr)
    u, s, vh = np.linalg.svd(rx)
    if not hasattr(plist, "__len__"):
        f = _pseudospectrum(u, s, freqlist, rows, int(plist),
                            use_signal_as_numerator)
    else:
        f = np.stack([
            _pseudospectrum(u, s, freqlist, rows, int(p),
                            use_signal_as_numerator) for p in plist])
    return f, u, s, vh


class CovarianceTechnique:
    """Base class holding covariance options + optional prewhitening
    (reference CovarianceTechnique, musicRoutines.py:187)."""

    def __init__(self, rows: int, snapshot_jump=None, fwd_bwd: bool = False,
                 avg_to_toeplitz: bool = False):
        self.rows = int(rows)
        self.snapshot_jump = snapshot_jump
        self.fwd_bwd = fwd_bwd
        self.avg_to_toeplitz = avg_to_toeplitz
        self.L = None  # prewhitening matrix (lower-triangular cholesky)

    def set_prewhitening_matrix(self, L: np.ndarray):
        self.L = np.asarray(L)

    def est_prewhitening_matrix(self, noise: np.ndarray):
        """Estimate the prewhitener as the Cholesky factor of the noise
        covariance."""
        rn = covariance(noise, self.rows, self.snapshot_jump)
        self.L = np.linalg.cholesky(rn)
        return self.L

    def calc_rx(self, x) -> np.ndarray:
        return covariance(x, self.rows, self.snapshot_jump, self.fwd_bwd,
                          self.avg_to_toeplitz)


class MUSIC(CovarianceTechnique):
    """MUSIC estimator class (reference MUSIC, musicRoutines.py:349)."""

    def run(self, x, freqlist, plist, use_signal_as_numerator: bool = False,
            prewhiten: bool = False):
        rx = self.calc_rx(x)
        if prewhiten:
            if self.L is None:
                raise ValueError("Set the prewhitening matrix first.")
            linv = np.linalg.inv(self.L)
            rx = linv @ rx @ linv.conj().T
        u, s, vh = np.linalg.svd(rx)
        if not hasattr(plist, "__len__"):
            f = _pseudospectrum(u, s, freqlist, self.rows, int(plist),
                                use_signal_as_numerator)
        else:
            f = np.stack([
                _pseudospectrum(u, s, freqlist, self.rows, int(p),
                                use_signal_as_numerator) for p in plist])
        return f, u, s, vh, rx

    @staticmethod
    def pick_peaks(f, p: int, height: float = 0):
        """Top-p peaks of the pseudospectrum (reference pickPeaks,
        musicRoutines.py:451)."""
        peakinds, props = sps.find_peaks(np.asarray(f), height=height)
        ph = props["peak_heights"]
        order = np.argsort(ph)[::-1]
        peakinds, ph = peakinds[order], ph[order]
        return peakinds[:p], ph[:p]


class CAPON(CovarianceTechnique):
    """Capon / MVDR spectrum (reference CAPON, musicRoutines.py:471)."""

    def run(self, x, freqlist):
        rx = self.calc_rx(x)
        inv_rx = np.linalg.inv(rx)
        freqlist = np.asarray(freqlist)
        eh = np.exp(-2j * np.pi * freqlist[:, None] * np.arange(self.rows))
        # f[i] = 1 / (eh_i inv_rx eh_i^H) — batched quadratic form
        denom = np.einsum("ij,jk,ik->i", eh, inv_rx, eh.conj())
        return 1.0 / denom, rx


class ESPRIT(CovarianceTechnique):
    """ESPRIT frequency estimates (reference ESPRIT, musicRoutines.py:500)."""

    def run(self, x, p: int, fs: float):
        rx = self.calc_rx(x)
        u, s, vh = np.linalg.svd(rx)
        sig_u = u[:, :p]
        phi, *_ = np.linalg.lstsq(sig_u[: self.rows - 1], sig_u[1:],
                                  rcond=None)
        w, v = np.linalg.eig(phi)
        freqs = np.angle(w) / (2 * np.pi) * fs
        return freqs, u, s, vh, rx


def music_xcorr(cutout, rx, f_search, ftap, fs: float, dsr: int, plist,
                musicrows: int = 130, shifts=None):
    """MUSIC-based xcorr: per shift, filter + polyphase-downsample the
    rx*conj(cutout) product and run MUSIC over all downsample phases as
    snapshots (reference musicXcorr, /root/reference/xcorrRoutines.py:378).

    Returns {p: (num_shifts, len(f_search)) pseudospectrum grid}.
    """
    cutout = np.asarray(cutout)
    rx = np.asarray(rx)
    ftap = np.asarray(ftap)
    cutoutconj = cutout.conj()
    music = MUSIC(musicrows, snapshot_jump=1, fwd_bwd=True)
    fs_ds = fs / dsr
    if shifts is None:
        shifts = np.arange(len(rx) - len(cutout) + 1)
    plist = np.atleast_1d(plist)
    resultsgrid = {int(p): np.zeros((len(shifts), len(f_search)))
                   for p in plist}
    f_search = np.asarray(f_search)
    for i, s in enumerate(shifts):
        pdt = rx[s: s + len(cutout)] * cutoutconj
        pdtfilt = sps.lfilter(ftap, 1, pdt)
        phases = {k: pdtfilt[len(ftap) // 2 + k:: dsr] for k in range(dsr)}
        f, u, sv, vh, rxcov = music.run(phases, f_search / fs_ds, plist,
                                        use_signal_as_numerator=True)
        f = np.atleast_2d(f)
        for k, p in enumerate(plist):
            resultsgrid[int(p)][i, :] = f[k]
    return resultsgrid


def _device_cov_fn(n: int, taps_len: int, dsr: int, rows: int,
                   num_shifts: int, fwd_bwd: bool):
    """Jitted batched modulate->filter->polyphase->covariance for music_xcorr:
    everything per shift EXCEPT the small-matrix SVD runs on the device in one
    program; only (num_shifts, rows, rows) covariances come back."""
    import functools
    import jax
    import jax.numpy as jnp

    @jax.jit
    def impl(cutout_conj, rx, shifts, ftap):
        def one_shift(s):
            pdt = jax.lax.dynamic_slice(rx, (s,), (n,)) * cutout_conj
            # causal FIR (scipy lfilter semantics): y[i] = sum_k h[k] pdt[i-k]
            from pydsproutines_tpu.ops.filters import _conv_causal_matmul
            pdtfilt = _conv_causal_matmul(ftap.astype(pdt.dtype), pdt)
            # dsr polyphase streams y_k = pdtfilt[taps_len//2 + k :: dsr],
            # each contributing sliding snapshot windows (jump=1); the
            # covariance over all phases is one accumulated outer product:
            # C = sum_k sum_j w_kj w_kj^H with w_kj = y_k[j : j+rows]
            start = taps_len // 2
            avail = (n - start) // dsr
            cols = avail - rows + 1

            def phase_cov(k):
                # every phase has exactly `avail` samples when (n - start)
                # is a dsr multiple (parity precondition with the numpy path)
                y = jax.lax.dynamic_slice(pdtfilt, (start + k,),
                                          (n - start - (dsr - 1),))[::dsr][:avail]
                idx = jnp.arange(rows)[:, None] + jnp.arange(cols)[None, :]
                xs = y[idx]                     # (rows, cols)
                return xs @ xs.conj().T

            c = jax.lax.map(phase_cov, jnp.arange(dsr)).sum(axis=0)
            c = c / (dsr * cols)
            if fwd_bwd:
                c = 0.5 * (c + jnp.flip(c, (0, 1)).T)
            return c

        return jax.lax.map(one_shift, shifts)

    return impl


def _device_music_grid_fn(rows: int, plist, f_norm, use_signal_as_numerator):
    """Jitted batched eig + pseudospectrum over per-shift covariances.

    The eigendecomposition is a vmapped ``jnp.linalg.eigh``, so the whole
    estimator stays on device (round-2 review: the host SVD round-trip
    per burst was the cap on MUSIC-based xcorr throughput).

    eigh returns eigenvalues ASCENDING; the SVD convention in
    ``_pseudospectrum`` is descending. The pseudospectrum depends only on the
    two subspace projectors, which are basis-invariant, so reversing the
    column order reproduces the host path exactly up to float error.
    """
    import jax
    import jax.numpy as jnp

    plist = [int(p) for p in np.atleast_1d(plist)]
    eh = np.exp(-2j * np.pi * np.asarray(f_norm).reshape(-1, 1)
                * np.arange(rows)).astype(np.complex64)

    @jax.jit
    def impl(covs):
        w, v = jax.vmap(jnp.linalg.eigh)(covs)      # ascending eigenvalues
        w_desc = w[:, ::-1]
        v_desc = v[:, :, ::-1]
        ehb = jnp.asarray(eh)

        grids = []
        for p in plist:
            d = jnp.einsum("fr,srk->sfk", ehb, v_desc[:, :, p:])
            denom = jnp.sum(jnp.abs(d) ** 2, axis=-1)
            if use_signal_as_numerator:
                ssp = w_desc[:, :p] ** -0.5          # (S, p)
                n = jnp.einsum("fr,srk,sk->sfk", ehb, v_desc[:, :, :p], ssp)
                numer = jnp.sum(jnp.abs(n) ** 2, axis=-1)
            else:
                numer = 1.0
            grids.append(numer / denom)
        return jnp.stack(grids)                      # (len(plist), S, F)

    return impl


def music_xcorr_device(cutout, rx, f_search, ftap, fs: float, dsr: int,
                       plist, musicrows: int = 130, shifts=None,
                       use_signal_as_numerator: bool = True,
                       eig_on_device: bool = True):
    """music_xcorr with everything on device: modulate, FIR, polyphase
    downsample, snapshot covariance, batched Hermitian eig, and the
    Vandermonde pseudospectrum products run in two jitted programs; only the
    final (num_shifts, len(f_search)) grids come back to host. Matches
    music_xcorr's output grid.

    ``eig_on_device=False`` restores the host np.linalg.svd per-shift path
    (kept as the parity oracle and for platforms without a usable eigh).

    Reference: musicXcorr (/root/reference/xcorrRoutines.py:378), which loops
    shifts in python and filters with scipy per shift.
    """
    import jax.numpy as jnp

    cutout = np.asarray(cutout)
    rx_np = np.asarray(rx)
    ftap = np.asarray(ftap)
    if shifts is None:
        shifts = np.arange(len(rx_np) - len(cutout) + 1)
    shifts = np.asarray(shifts)
    plist = np.atleast_1d(plist)
    f_search = np.asarray(f_search)
    fs_ds = fs / dsr

    fn = _device_cov_fn(len(cutout), len(ftap), int(dsr), int(musicrows),
                        len(shifts), fwd_bwd=True)
    covs = fn(jnp.asarray(np.conj(cutout)), jnp.asarray(rx_np),
              jnp.asarray(shifts.astype(np.int32)), jnp.asarray(ftap))

    if eig_on_device:
        grid_fn = _device_music_grid_fn(int(musicrows), plist,
                                        f_search / fs_ds,
                                        use_signal_as_numerator)
        grids = np.asarray(grid_fn(covs))
        return {int(p): grids[k] for k, p in enumerate(plist)}

    covs = np.asarray(covs)
    resultsgrid = {int(p): np.zeros((len(shifts), len(f_search)))
                   for p in plist}
    for i in range(len(shifts)):
        u, s, vh = np.linalg.svd(covs[i])
        for p in plist:
            resultsgrid[int(p)][i, :] = _pseudospectrum(
                u, s, f_search / fs_ds, musicrows, int(p),
                use_signal_as_numerator)
    return resultsgrid
