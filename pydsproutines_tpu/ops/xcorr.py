"""Cross-correlation / CAF (Complex Ambiguity Function) search.

Re-expresses the reference's xcorrRoutines (/root/reference/xcorrRoutines.py:
fastXcorr :460, cztXcorr :413, fineFreqTimeSearch :583, makeTimeScanSteervec
:670, calcQF2 :833, QF2/SNR conversions :723-772, theoreticalMultiPeak :775)
as batched jax pipelines.

Design (SURVEY.md §7.4): instead of a per-shift python loop (CPU reference)
or slice-copy CUDA kernels + cuFFT batches (GPU reference), shifts are
gathered into a (batch, N) matrix with vmap'd dynamic slices, multiplied by
the conjugated template, pushed through one batched FFT/CZT, and reduced with
a fused |.|^2-argmax — all inside a single jit. Long shift lists stream through
``lax.scan`` chunks with static shapes so nothing recompiles. Sharding over
shifts across a device mesh lives in pydsproutines_tpu.parallel.xcorr.

QF^2 convention: result = |peak|^2 / ||rx slice||^2 / ||cutout||^2, a
normalized 0..1 correlation power.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.ops.spectral import CZT
from pydsproutines_tpu.utils.dtypes import real_dtype_for
from pydsproutines_tpu.utils.freq import make_freq


# ---------------------------------------------------------------------------
# Core batched shift-gather helpers
# ---------------------------------------------------------------------------

def gather_shift_slices(rx: jnp.ndarray, shifts: jnp.ndarray, n: int,
                        step: int | None = None) -> jnp.ndarray:
    """Gather rx[s:s+n] for each s in shifts into a (len(shifts), n) matrix.

    The equivalent of the reference's copySlicesToMatrix_32fc CUDA kernel
    (/root/reference/custom_kernels/copying.cu:9).

    When the shifts are an arithmetic progression with static ``step``, one
    dynamic slice grabs the covering window and the rows are static slices
    of it; other shift lists take one dynamic slice per shift.
    """
    if step is not None:
        b = shifts.shape[0]
        window = jax.lax.dynamic_slice(rx, (shifts[0],),
                                       ((b - 1) * step + n,))
        return jnp.stack([jax.lax.slice(window, (i * step,), (i * step + n,))
                          for i in range(b)])
    return jax.vmap(lambda s: jax.lax.dynamic_slice(rx, (s,), (n,)))(shifts)


def _abs_sq(x: jnp.ndarray) -> jnp.ndarray:
    return x.real * x.real + x.imag * x.imag


def _chunked_map(fn, shifts: jnp.ndarray, batch_size: int,
                 step: int | None = None):
    """Apply ``fn`` (a vmappable function of a shift-chunk array) over shifts
    in static-shape chunks of ``batch_size``, concatenating results.

    The last chunk is padded (with the continued progression when ``step`` is
    given, else by repeating the final shift); padded results are trimmed, so
    one compiled program serves any number of shifts.
    """
    k = shifts.shape[0]
    nchunks = -(-k // batch_size)
    pad = nchunks * batch_size - k
    if step is not None:
        tail = shifts[-1] + step * jnp.arange(1, pad + 1, dtype=shifts.dtype)
    else:
        tail = jnp.broadcast_to(shifts[-1:], (pad,))
    padded = jnp.concatenate([shifts, tail])
    chunks = padded.reshape(nchunks, batch_size)
    out = jax.lax.map(fn, chunks)
    return jax.tree_util.tree_map(
        lambda a: a.reshape((nchunks * batch_size,) + a.shape[2:])[:k], out)


def _uniform_step(shifts) -> int | None:
    """Detect a static arithmetic progression in a host-side shifts array.

    Multi-process global arrays cannot be np.asarray'd (only local shards
    are addressable); the LOCAL shard suffices — shard_map hands each device
    a contiguous block, so a uniform global progression is uniform per
    block, which is all the gather tiers need."""
    try:
        s = np.asarray(shifts)
    except Exception:
        try:
            s = np.asarray(shifts.addressable_shards[0].data)
        except Exception:
            return None
    if s.ndim != 1 or s.size < 2 or not np.issubdtype(s.dtype, np.integer):
        return None if s.size > 1 else 1
    d = np.diff(s)
    if np.all(d == d[0]) and d[0] > 0:
        return int(d[0])
    return None


# ---------------------------------------------------------------------------
# fastXcorr
# ---------------------------------------------------------------------------

_log = logging.getLogger("pydsproutines_tpu.xcorr")


def select_xcorr_path(freqsearch: bool, output_caf: bool,
                      step: int | None) -> tuple[str, str]:
    """The compile-time routing decision of fast_xcorr, exposed for
    observability. Returns (path, reason), where path is one of:

      "dot"   no frequency search: plain sliding dot products
      "caf"   full CAF output: batched FFT of every shift's product
      "peak"  frequency-scan peak search: batched FFT -> |.|^2 -> argmax

    ``reason`` names the shift-gather tier: uniform-step sweeps take one
    dynamic window per chunk; other shift lists gather per shift."""
    if not freqsearch:
        path = "dot"
    elif output_caf:
        path = "caf"
    else:
        path = "peak"
    reason = "" if step is not None else \
        "shifts are not a uniform progression: per-shift gather"
    return path, reason


@functools.partial(
    jax.jit,
    static_argnames=("n", "freqsearch", "output_caf", "abs_result",
                     "batch_size", "step"),
)
def _fast_xcorr_impl(cutout, rx, shifts, *, n, freqsearch, output_caf,
                     abs_result, batch_size, step=None):
    rdt = real_dtype_for(cutout.dtype)
    cutout_norm_sq = jnp.sum(_abs_sq(cutout)).astype(rdt)
    cutout_norm = jnp.sqrt(cutout_norm_sq)
    cutout_conj = jnp.conj(cutout)

    def chunk_fn(chunk):
        slices = gather_shift_slices(rx, chunk, n, step)
        # exact per-window energies: a prefix-sum difference loses
        # ~eps * len(rx) / n of relative accuracy
        rx_norm_sq = jnp.sum(_abs_sq(slices), axis=-1)
        if not freqsearch:
            # vdot semantics: sum(conj(rx_slice) * cutout)
            prod = jnp.sum(jnp.conj(slices) * cutout, axis=-1)
            if abs_result:
                return _abs_sq(prod) / cutout_norm_sq / rx_norm_sq
            return prod / cutout_norm / jnp.sqrt(rx_norm_sq)
        pdtfft = jnp.fft.fft(slices * cutout_conj, axis=-1)
        if output_caf:
            if abs_result:
                return _abs_sq(pdtfft) / cutout_norm_sq / rx_norm_sq[:, None]
            return pdtfft / cutout_norm / jnp.sqrt(rx_norm_sq)[:, None]
        mag_sq = _abs_sq(pdtfft)
        imax = jnp.argmax(mag_sq, axis=-1)
        if abs_result:
            return (jnp.max(mag_sq, axis=-1) / cutout_norm_sq / rx_norm_sq,
                    imax.astype(jnp.uint32))
        peak = jnp.take_along_axis(pdtfft, imax[:, None], axis=-1)[:, 0]
        return (peak / cutout_norm / jnp.sqrt(rx_norm_sq),
                imax.astype(jnp.uint32))

    return _chunked_map(chunk_fn, shifts, batch_size, step)


def fast_xcorr(cutout: jnp.ndarray, rx: jnp.ndarray, freqsearch: bool = False,
               output_caf: bool = False, shifts=None, abs_result: bool = True,
               batch_size: int = 128, precision: str | None = None,
               step: int | None = None):
    """Sliding-window normalized xcorr with optional per-shift frequency scan
    (reference fastXcorr, xcorrRoutines.py:460).

    Parameters mirror the reference. Returns:
      * no freqsearch: QF^2 array (or complex QF when ``abs_result=False``)
      * freqsearch, no CAF: (QF^2 array, uint32 peak-frequency bin per shift)
      * freqsearch + output_caf: full (num_shifts, len(cutout)) CAF

    ``batch_size`` controls the static chunk of shifts processed per step of
    the internal ``lax.map`` stream (the reference GPU BATCH loop,
    xcorrRoutines.py:84-151). ``step`` declares the shifts' uniform stride
    when calling from INSIDE a jit (traced shifts are host-opaque and would
    silently take the per-shift gather tier).

    ``precision`` names the grade of the frequency scan, and has one value:
    "f32" (the default, also for None). The scan's FFTs run at the input's
    own precision through XLA's FFT (cuFFT on a GPU): complex64 input gives
    float32-FFT-grade QF^2 values and bins for every shift, not only the
    peak. Any other value raises ValueError.
    """
    if precision not in (None, "f32"):
        raise ValueError(
            f"precision={precision!r}: the frequency scan has one grade, "
            "'f32'")
    if cutout.shape[-1] > rx.shape[-1]:
        raise ValueError(
            f"cutout (len {cutout.shape[-1]}) is longer than rx (len {rx.shape[-1]})")
    if shifts is None:
        shifts = jnp.arange(rx.shape[-1] - cutout.shape[-1] + 1)
        step = 1
    if step is None:
        # NOTE: traced shift arrays (calls from inside a jit) cannot be
        # inspected host-side, so the uniform stride is undetectable and the
        # sweep takes the per-shift gather tier — declare ``step=`` there.
        step = _uniform_step(shifts)
    shifts = jnp.asarray(shifts)
    if shifts.shape[0] == 0:
        raise ValueError("shifts must be non-empty")
    try:  # host-side validation when shifts are concrete
        max_shift = int(np.max(np.asarray(shifts)))
        if max_shift + cutout.shape[-1] > rx.shape[-1]:
            raise ValueError(
                f"max shift {max_shift} + cutout length {cutout.shape[-1]} "
                f"exceeds rx length {rx.shape[-1]}")
    except TypeError:
        pass  # traced shifts: caller must guarantee range
    batch_size = int(min(batch_size, shifts.shape[0]))
    path, reason = select_xcorr_path(bool(freqsearch), bool(output_caf), step)
    _log.debug("fast_xcorr n=%d: %s path%s", int(cutout.shape[-1]), path,
               f" ({reason})" if reason else "")
    return _fast_xcorr_impl(
        cutout, rx, shifts, n=cutout.shape[-1], freqsearch=bool(freqsearch),
        output_caf=bool(output_caf), abs_result=bool(abs_result),
        batch_size=batch_size, step=step)


# ---------------------------------------------------------------------------
# cztXcorr — frequency scan on an arbitrary CZT grid
# ---------------------------------------------------------------------------

def czt_xcorr(cutout: jnp.ndarray, rx: jnp.ndarray, f_search_min: float,
              f_search_max: float, fs: float, czt_step: float = 0.1,
              output_caf: bool = False, shifts=None, batch_size: int = 128):
    """Sliding xcorr with a CZT fine-frequency scan (reference cztXcorr,
    xcorrRoutines.py:413).

    Returns (caf, f_search) when ``output_caf`` else (complex peak values,
    peak frequency in Hz per shift).
    """
    n = cutout.shape[-1]
    from pydsproutines_tpu.ops.spectral import get_czt_plan
    plan = get_czt_plan(n, float(f_search_min), float(f_search_max),
                        float(czt_step), float(fs), str(jnp.dtype(cutout.dtype)))
    f_search_np = plan.freqs().astype(np.dtype(real_dtype_for(cutout.dtype)))
    if n > rx.shape[-1]:
        raise ValueError(f"cutout (len {n}) is longer than rx (len {rx.shape[-1]})")
    if shifts is None:
        shifts = jnp.arange(rx.shape[-1] - n + 1)
    shifts = jnp.asarray(shifts)
    if shifts.shape[0] == 0:
        raise ValueError("shifts must be non-empty")
    batch_size = int(min(batch_size, shifts.shape[0]))

    out = _czt_xcorr_fn(plan, f_search_np, bool(output_caf),
                        batch_size)(cutout, rx, shifts)
    if output_caf:
        return out, jnp.asarray(f_search_np)
    return out


def _czt_xcorr_fn(plan: CZT, f_search_np: np.ndarray, output_caf: bool,
                  batch_size: int):
    """Per-plan jitted sweep closure; the host chirp constants are embedded
    as program constants."""
    key = ("xc", output_caf, batch_size)
    fn = plan.__dict__.setdefault("_xc_fns", {}).get(key)
    if fn is not None:
        return fn
    aa, fv, ww_tail = plan.aa, plan.fv, plan.ww_tail
    n, k, nfft = plan.m, plan.k, plan.nfft

    def _impl(cutout, rx, shifts):
        rdt = real_dtype_for(cutout.dtype)
        cutout_norm_sq = jnp.sum(_abs_sq(cutout)).astype(rdt)
        cutout_norm = jnp.sqrt(cutout_norm_sq)
        cutout_conj = jnp.conj(cutout)

        def czt_rows(pdt):
            fy = jnp.fft.fft(pdt * aa, n=nfft, axis=-1)
            g = jnp.fft.ifft(fy * fv, axis=-1)
            return g[..., n - 1: n + k - 1] * ww_tail

        def chunk_fn(chunk):
            slices = gather_shift_slices(rx, chunk, n)
            rx_norm_sq = jnp.sum(_abs_sq(slices), axis=-1)
            pdtczt = czt_rows(slices * cutout_conj)
            mag = _abs_sq(pdtczt)
            if output_caf:
                return mag / rx_norm_sq[:, None] / cutout_norm_sq
            mi = jnp.argmax(mag, axis=-1)
            peak = jnp.take_along_axis(pdtczt, mi[:, None], axis=-1)[:, 0]
            result = peak / jnp.sqrt(rx_norm_sq) / cutout_norm
            return result, jnp.asarray(f_search_np)[mi]

        return _chunked_map(chunk_fn, shifts, batch_size)

    fn = plan._xc_fns.setdefault(key, jax.jit(_impl))
    return fn


# ---------------------------------------------------------------------------
# Fine time/frequency refinement
# ---------------------------------------------------------------------------

def make_time_scan_steervec(td_scan_range: jnp.ndarray, fs: float,
                            siglen: int, dtype=jnp.complex64) -> jnp.ndarray:
    """Steering-vector matrix exp(1j*2*pi*f*td) over the FFT frequency axis
    (reference makeTimeScanSteervec, xcorrRoutines.py:670)."""
    rdt = real_dtype_for(dtype)
    f = make_freq(siglen, fs, dtype=rdt)
    td = jnp.asarray(td_scan_range, dtype=rdt)
    return jnp.exp(1j * 2 * jnp.pi * f[None, :] * td[:, None]).astype(dtype)


def fine_freq_time_search(x_aligned: jnp.ndarray, y_aligned: jnp.ndarray,
                          fine_res, freqfound: float, freq_res: float,
                          fs: float, td_scan_range, steeringvec=None,
                          td_scan_freq_bounds=None):
    """Two-pass fine frequency then sub-sample time alignment (reference
    fineFreqTimeSearch, xcorrRoutines.py:583).

    Convention: positive timediff means y_aligned is LATER than x_aligned.
    Returns (fine_freq_found, timediff, cost_vec).
    """
    n = x_aligned.shape[-1]
    rdt = real_dtype_for(x_aligned.dtype)
    cdt = x_aligned.dtype
    nn = jnp.arange(n, dtype=rdt)
    freqfound = jnp.asarray(freqfound, dtype=rdt)

    fine_res = list(np.atleast_1d(fine_res)) if fine_res is not None else []
    fine_freq_found = None
    if len(fine_res) > 0:
        precomputed = jnp.conj(y_aligned) * x_aligned
        best_shift = jnp.ones(n, dtype=cdt)
        for res in fine_res:
            num = int(np.ceil(2.0 * freq_res / res))
            offsets = jnp.arange(num, dtype=rdt) * res - freq_res
            fine_freqs = freqfound + offsets
            # fineshifts[j] = exp(-1j*2*pi*f_j*n/fs); pp[j] = vdot(precomputed, shift_j)
            shifts_mat = jnp.exp(
                (-1j * 2 * jnp.pi / fs) * fine_freqs[:, None] * nn[None, :]
            ).astype(cdt)
            pp = jnp.matmul(shifts_mat, jnp.conj(precomputed),
                            precision=jax.lax.Precision.HIGHEST)
            i = jnp.argmax(jnp.abs(pp))
            freqfound = fine_freqs[i]
            best_shift = shifts_mat[i]
        fine_freq_found = freqfound
        # Align x to y's tone: y*conj(x) ~ e^{j*2*pi*fhat*t}, so x needs
        # e^{+j*2*pi*fhat*t} = conj(best_shift). (Deviation from the literal
        # reference, which multiplies by best_shift itself — xcorrRoutines.py
        # :637 — doubling the tone mismatch and biasing the subsequent
        # sub-sample delay; verified against scenes with known Doppler+tau.)
        x_aligned = x_aligned * jnp.conj(best_shift)

    if steeringvec is None:
        steeringvec = make_time_scan_steervec(td_scan_range, fs, n, dtype=cdt)
    td_scan_range = jnp.asarray(td_scan_range)

    x_fft = jnp.fft.fft(x_aligned)
    y_fft = jnp.fft.fft(y_aligned)
    rx_vec = x_fft * jnp.conj(y_fft)
    if td_scan_freq_bounds is not None:
        fvec = make_freq(n, fs, dtype=rdt)
        mask = (fvec >= td_scan_freq_bounds[0]) & (fvec < td_scan_freq_bounds[1])
        rx_vec = jnp.where(mask, rx_vec, 0)
    cost_vec = (jnp.matmul(steeringvec.conj(), rx_vec,
                           precision=jax.lax.Precision.HIGHEST)
                / jnp.linalg.norm(x_fft) / jnp.linalg.norm(y_fft))
    idx_td = jnp.argmax(jnp.abs(cost_vec))
    timediff = td_scan_range[idx_td]
    return fine_freq_found, timediff, cost_vec


class GenXcorr:
    """Cached steering-vector fine time-offset estimator (reference GenXcorr,
    xcorrRoutines.py:679)."""

    def __init__(self, td_scan_range, fs: float, siglen: int, dtype=jnp.complex64):
        self.td_scan_range = jnp.asarray(td_scan_range)
        self.fs = fs
        self.siglen = siglen
        self.steeringvec = make_time_scan_steervec(td_scan_range, fs, siglen, dtype)
        self.td_scan_freq_bounds = None

    def set_td_scan_freq_bounds(self, bounds):
        self.td_scan_freq_bounds = bounds

    def xcorr(self, x: jnp.ndarray, y: jnp.ndarray):
        _, timediff, cost_vec = fine_freq_time_search(
            x, y, [], 0.0, 0.0, self.fs, self.td_scan_range,
            steeringvec=self.steeringvec,
            td_scan_freq_bounds=self.td_scan_freq_bounds)
        return timediff, cost_vec


# ---------------------------------------------------------------------------
# QF^2 / SNR conversions and accuracy bounds (Stein)
# ---------------------------------------------------------------------------

def calc_qf2(x: jnp.ndarray, y: jnp.ndarray):
    """QF^2 of two aligned equal-length arrays; row-wise for 2-D inputs
    (reference calcQF2, xcorrRoutines.py:833)."""
    if x.ndim == 1:
        xe = jnp.sum(_abs_sq(x))
        ye = jnp.sum(_abs_sq(y))
        return _abs_sq(jnp.vdot(x, y)) / xe / ye
    xe = jnp.sum(_abs_sq(x), axis=1)
    ye = jnp.sum(_abs_sq(y), axis=1)
    return _abs_sq(jnp.sum(x * jnp.conj(y), axis=1)) / xe / ye


def convert_qf2_to_snr(qf2):
    """For xcorr against a pure (noiseless) template."""
    return qf2 / (1.0 - qf2)


def convert_qf2_to_eff_snr(qf2):
    """For xcorr of two noisy signals."""
    return 2.0 * qf2 / (1.0 - qf2)


def convert_eff_snr_to_qf2(eff_snr):
    return eff_snr / (2.0 + eff_snr)


def expected_eff_snr(snr1, snr2=np.inf, osr: float = 1):
    """Stein's effective SNR 1/(0.5*(1/y1 + 1/y2 + 1/(y1*y2))), scaled by OSR
    (reference expectedEffSNR, xcorrRoutines.py:738)."""
    y = 1.0 / (0.5 * (1.0 / snr1 + 1.0 / snr2 + 1.0 / (snr1 * snr2)))
    return y / osr


def sigma_dto(signal_bw, noise_bw, integ_time, eff_snr):
    """Stein DTO standard deviation (xcorrRoutines.py:758)."""
    beta = np.pi / np.sqrt(3.0) * signal_bw
    return 1.0 / beta / np.sqrt(noise_bw * integ_time * eff_snr)


def sigma_dfo(noise_bw, integ_time, eff_snr):
    """Stein DFO standard deviation (xcorrRoutines.py:767)."""
    return 0.55 / integ_time / np.sqrt(noise_bw * integ_time * eff_snr)


def theoretical_multi_peak(start_idx1, start_idx2, snr_linear_1=None,
                           snr_linear_2=None):
    """Expected xcorr peak offsets (and effective SNRs) from multiple signal
    copies in two receivers (reference theoreticalMultiPeak,
    xcorrRoutines.py:775). Host-side numpy (dynamic unique)."""
    start_idx1 = np.asarray(start_idx1)
    start_idx2 = np.asarray(start_idx2)
    mat = start_idx2[:, None] - start_idx1[None, :]
    if snr_linear_1 is None and snr_linear_2 is None:
        return np.unique(mat.flatten())
    snr_linear_2 = np.asarray(snr_linear_2)
    tmp = 0.5 * (1.0 / snr_linear_1 + 1.0 / snr_linear_2[:, None]
                 + 1.0 / (snr_linear_1 * snr_linear_2[:, None]))
    eff = np.broadcast_to(1.0 / tmp, mat.shape)
    u, indices = np.unique(mat.flatten(), return_index=True)
    return u, eff.flatten()[indices]


def argmax2d(m: jnp.ndarray):
    """2-D indices of the matrix maximum (reference argmax2d,
    xcorrRoutines.py:815)."""
    idx = jnp.argmax(m)
    return jnp.unravel_index(idx, m.shape)


def compute_fast_xcorr_complexity(n, k=1):
    """Operation-count model of the freq-scanning sliding xcorr — K shifts,
    one length-N FFT each (reference computeFastXcorrComplexity,
    xcorrRoutines.py:2084)."""
    return k * n * np.log2(n)


def compute_group_xcorr_czt_complexity(m, group_len, czt_points, k=1):
    """Operation-count model of the CZT group xcorr — K shifts x m groups,
    each a Bluestein CZT costing two FFTs of the next fast length covering
    group_len + czt_points (reference computeGroupXcorrCZTcomplexity,
    xcorrRoutines.py:2099)."""
    from pydsproutines_tpu.utils.fftlen import next_fast_len
    lc = next_fast_len(int(group_len + czt_points))
    return k * m * 2 * lc * np.log2(lc)
