"""FIR filtering, rational resampling (upfirdn), moving sums/averages, and
median filtering.

Reference semantics: /root/reference/filterRoutines.py (cp_lfilter :24,
CupyFilter :57, CupyKernelFilter.getUpfirdnSize :130 / upfirdn kernels,
cupyMultiMovingAverage :1129, cupyMovingAverage :1167, cupyComplexMovingSum
:1206, resampleFactorWizard :1090) and custom_kernels/filter.cu / upfirdn.cu.

Design: one jax implementation per op. Short-tap FIR runs as a blocked
Toeplitz matmul at full float32 precision; long taps can use FFT overlap
multiplication. Streaming state (the reference's ``delay``
members) is an explicit carry array so block processing works under jit with
static shapes and no recompiles.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.utils.dtypes import real_dtype_for
from pydsproutines_tpu.utils.fftlen import next_fast_len


# ---------------------------------------------------------------------------
# FIR filtering
# ---------------------------------------------------------------------------

def _conv_causal_matmul(taps: jnp.ndarray, x: jnp.ndarray,
                        block: int = 256) -> jnp.ndarray:
    """Causal convolution y[i] = sum_k taps[k] x[i-k], len(y) == len(x),
    as a blocked-Toeplitz matmul.

    Output blocks of ``block`` samples each contract one (W = block+T-1)-wide
    input window against a banded (W, block) tap matrix — a batched matmul
    (the reference's filter_smtaps shared-mem kernel,
    custom_kernels/filter.cu:9). Also the robust formulation for huge 1-D
    signals, where a direct XLA convolution at spatial width ~1e6 compiles
    slowly.
    """
    T = taps.shape[-1]
    n = x.shape[-1]
    C = int(block)
    rows = -(-n // C)
    W = C + T - 1
    dt = jnp.result_type(taps.dtype, x.dtype)
    xp = jnp.concatenate([
        jnp.zeros(T - 1, dt), x.astype(dt),
        jnp.zeros(rows * C - n + C, dt)])
    # windows[j, t] = xp[j*C + t] via shifted reshapes (no per-row gather)
    r = -(-W // C)
    parts = [jax.lax.slice(xp, (i * C,), (i * C + rows * C,)).reshape(rows, C)
             for i in range(r)]
    win = jnp.concatenate(parts, axis=1)[:, :W]          # (rows, W)
    # K[t, c] = taps[c + T - 1 - t] on the band, 0 elsewhere
    t_idx = np.arange(W)[:, None]
    c_idx = np.arange(C)[None, :]
    k = c_idx + T - 1 - t_idx
    mask = jnp.asarray((k >= 0) & (k < T))
    K = jnp.where(mask, taps.astype(dt)[np.clip(k, 0, T - 1)], 0)
    y = jnp.matmul(win, K, precision=jax.lax.Precision.HIGHEST)
    return y.reshape(-1)[:n]


def _conv_full(taps: jnp.ndarray, x: jnp.ndarray, method: str) -> jnp.ndarray:
    """Full linear convolution of 1-D ``taps`` with 1-D ``x``."""
    if method == "fft":
        n = x.shape[-1] + taps.shape[-1] - 1
        nfft = next_fast_len(n)
        cdt = jnp.result_type(taps.dtype, x.dtype, jnp.complex64)
        X = jnp.fft.fft(x.astype(cdt), nfft)
        H = jnp.fft.fft(taps.astype(cdt), nfft)
        y = jnp.fft.ifft(X * H)[:n]
        if not jnp.issubdtype(jnp.result_type(taps.dtype, x.dtype), jnp.complexfloating):
            y = y.real
        return y.astype(jnp.result_type(taps.dtype, x.dtype))
    return jnp.convolve(x, taps, mode="full")


@functools.partial(jax.jit, static_argnames=("method",))
def lfilter_fir(taps: jnp.ndarray, x: jnp.ndarray, method: str = "direct") -> jnp.ndarray:
    """FIR filter: y[n] = sum_k taps[k] * x[n-k], output length == len(x)
    (reference cp_lfilter, filterRoutines.py:24: convolve(ftap, x)[:x.size]).

    ``method``: "direct" (blocked-Toeplitz matmul, short/medium taps) or
    "fft" (overlap in frequency domain, better for very long taps)."""
    if method == "direct":
        return _conv_causal_matmul(taps, x)
    return _conv_full(taps, x, method)[: x.shape[-1]]


class StreamFilter:
    """Streaming FIR filter with explicit delay-line carry (reference
    CupyFilter, filterRoutines.py:57).

    Successive calls to :meth:`lfilter` on contiguous blocks produce the same
    output as one call on the concatenated signal. The carry is a pytree leaf
    (a jnp array), so the step stays jittable with static shapes.
    """

    def __init__(self, taps: jnp.ndarray, dtype=jnp.complex64):
        self.taps = jnp.asarray(taps)
        self.dtype = jnp.dtype(dtype)
        self.delay = jnp.zeros(self.taps.shape[-1], dtype=self.dtype)

    def reset(self):
        self.delay = jnp.zeros_like(self.delay)

    def lfilter(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=self.dtype)
        y, self.delay = stream_lfilter_step(self.taps, x, self.delay)
        return y


@jax.jit
def stream_lfilter_step(taps, x, delay):
    """One streaming FIR block step. Returns (filtered block, new delay).

    ``delay`` holds the last len(taps) input samples of the previous block.
    """
    t = taps.shape[-1]
    xp = jnp.concatenate([delay, x])
    c = _conv_causal_matmul(taps, xp)
    y = c[t: t + x.shape[-1]]
    new_delay = xp[-t:]
    return y, new_delay


# ---------------------------------------------------------------------------
# upfirdn — scipy-size-compatible rational resampling
# ---------------------------------------------------------------------------

def get_upfirdn_size(original_size: int, taps_size: int, up: int, down: int) -> int:
    """Output size matching scipy.signal.upfirdn (reference getUpfirdnSize,
    filterRoutines.py:130): ceil((n*up - (up-1) + T - 1)/down)."""
    return int(np.ceil((original_size * up - (up - 1) + taps_size - 1) / down))


def _upfirdn_poly_planes(planes: jnp.ndarray, taps_r: jnp.ndarray, up: int,
                         down: int, n_out: int) -> jnp.ndarray:
    """Strided polyphase upfirdn core on real planes.

    planes: (rows, n) real. Output j satisfies out[j] = sum_l h[p_j + l*up] *
    x[q_j - l] with m = j*down, p = m % up, q = m // up — the polyphase
    identity behind the reference's shared-mem kernel
    (/root/reference/custom_kernels/upfirdn.cu:69), here expressed as ONE
    strided XLA convolution: outputs are grouped by phase period P = up/g into
    conv output channels, per-channel tap offsets absorbed into a widened
    kernel, input stride S = down/g. No zero-stuffed intermediate is ever
    materialized and the MAC count is n*T/down (up*down-fold fewer than the
    naive stuff-then-convolve form).
    """
    g = math.gcd(up, down)
    P = up // g                       # outputs per phase period
    S = down // g                     # input samples per phase period
    T = taps_r.shape[-1]
    Lh = -(-T // up)                  # taps per polyphase branch
    hpad = jnp.pad(taps_r, (0, Lh * up - T))   # pad: cheap on traced taps
    Hp = hpad.reshape(Lh, up).T       # Hp[p, l] = h[p + l*up]

    c = np.arange(P)
    p_c = (c * down) % up
    qc_c = (c * down) // up           # per-channel input offset (monotone)
    qmax = int(qc_c[-1])
    Lw = Lh + qmax

    # group Gp phase periods per output block so (a) the output minor dim
    # is a multiple of 128 and (b) the block stride Gp*S is ~half the window
    # width, so the shifted-reshape window build reads the input ~2x
    # instead of ceil(W/stride) times. The raw per-period form has only P
    # outputs per block (at up=5 a 5-wide minor axis).
    # Derivation: out[b*Gp*P + g*P + c] = sum_l Hp[p_c, l] * x[q - l] with
    # q = b*Gp*S + g*S + qc_c (exact: (Gp*P*down) % up == 0), so one
    # (rows, W) window per block against a banded (W, Gp*P) tap matrix.
    cols0 = int(np.lcm(P, 128))
    gp = cols0 // P
    while gp * P < 256:
        gp *= 2
    while gp * P > 2048 and gp % 2 == 0 and (gp // 2) * P % 128 == 0:
        gp //= 2
    cols = gp * P                     # outputs per block, 128-aligned
    W = (gp - 1) * S + Lw             # window width per block
    # static (W, cols) index/valid maps; traced tap values gathered (a
    # scatter build stops const-folding when upfirdn runs nested in a
    # caller's jit)
    t_full = np.arange(W)[:, None]
    col_full = np.arange(cols)[None, :]
    gi_f = col_full // P
    ci_f = col_full % P
    l_f = (gi_f * S + qc_c[ci_f] + Lh - 1) - t_full
    valid = (l_f >= 0) & (l_f < Lh)
    Kj = jnp.where(jnp.asarray(valid),
                   Hp[jnp.asarray(p_c[ci_f]), jnp.asarray(np.clip(
                       l_f, 0, Lh - 1))], 0)

    nblocks = -(-n_out // cols)
    left = Lh - 1                     # aligns xp[b*Gp*S + t] with x[q - l]
    stride = gp * S
    rr = -(-W // stride)
    need = (nblocks - 1) * stride + rr * stride
    right = max(0, need - (planes.shape[-1] + left))
    xp = jnp.pad(planes, ((0, 0), (left, right)))
    rows = planes.shape[0]
    # win[r, b, t] = xp[r, b*Gp*S + t] via shifted reshapes (an XLA strided
    # conv here compiles slowly at ~1e6 widths)
    parts = [jax.lax.slice(xp, (0, i * stride),
                           (rows, i * stride + nblocks * stride))
             .reshape(rows, nblocks, stride) for i in range(rr)]
    win = jnp.concatenate(parts, axis=2)[:, :, :W]      # (rows, B, W)
    out = jnp.einsum("rbt,tc->rbc", win, Kj,
                     # full f32 precision: filters are parity-grade ops
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(rows, nblocks * cols)[:, :n_out]


@functools.partial(jax.jit, static_argnames=("up", "down"))
def upfirdn(taps: jnp.ndarray, x: jnp.ndarray, up: int, down: int) -> jnp.ndarray:
    """Upsample-filter-downsample identical to scipy.signal.upfirdn
    (reference upfirdn kernels, custom_kernels/upfirdn.cu).

    Works on 1-D input or row-wise on 2-D input (the reference's upfirdn_sm
    batch kernel). Polyphase: never materializes the zero-stuffed signal.
    """
    squeeze = x.ndim == 1
    x2 = jnp.atleast_2d(x)
    n = x2.shape[-1]
    n_out = get_upfirdn_size(n, taps.shape[-1], up, down)
    x_cplx = jnp.issubdtype(x2.dtype, jnp.complexfloating)
    t_cplx = jnp.issubdtype(jnp.asarray(taps).dtype, jnp.complexfloating)
    rdt = real_dtype_for(jnp.result_type(x2.dtype, taps.dtype))
    rows = x2.shape[0]
    if x_cplx:
        planes = jnp.concatenate(
            [x2.real.astype(rdt), x2.imag.astype(rdt)], axis=0)
    else:
        planes = x2.astype(rdt)
    if not t_cplx:
        y = _upfirdn_poly_planes(planes, jnp.asarray(taps).astype(rdt),
                                 up, down, n_out)
        if x_cplx:
            out = jax.lax.complex(y[:rows], y[rows:])
        else:
            out = y.astype(x2.dtype)
    else:
        yr = _upfirdn_poly_planes(planes, jnp.real(taps).astype(rdt),
                                  up, down, n_out)
        yi = _upfirdn_poly_planes(planes, jnp.imag(taps).astype(rdt),
                                  up, down, n_out)
        if x_cplx:
            out = jax.lax.complex(yr[:rows] - yi[rows:], yr[rows:] + yi[:rows])
        else:
            out = jax.lax.complex(yr, yi)
    out = out.astype(jnp.result_type(x2.dtype, taps.dtype))
    return out[0] if squeeze else out


@functools.partial(jax.jit, static_argnames=("up", "down"))
def fir_upfirdn(fir_taps: jnp.ndarray, rs_taps: jnp.ndarray, x: jnp.ndarray,
                up: int, down: int) -> jnp.ndarray:
    """Fused FIR filter + polyphase resample in ONE memory pass.

    Algebraic identity: upsampling commutes with convolution
    (up(a) * up(b) = up(a conv b) at the nonzero taps), so the chain
    ``upfirdn(rs_taps, lfilter_fir(fir_taps, x), up, down)`` equals a single
    upfirdn with combined taps conv(upsample(fir_taps, up), rs_taps). This is
    the analogue of the reference's fused decimating FIR kernels
    (/root/reference/custom_kernels/filter.cu:9 fuses filter+downsample).

    Output length matches the two-op chain. The fused form applies the FULL
    FIR convolution — the chain's lfilter truncates the FIR tail, so the last
    ceil((len(rs_taps) - 1) / down) output samples differ from the chain
    (the fused values are the ones scipy's full-conv semantics produce);
    everything before that is identical to float precision.
    """
    t1 = fir_taps.shape[-1]
    t2 = rs_taps.shape[-1]
    if (jnp.issubdtype(jnp.asarray(fir_taps).dtype, jnp.complexfloating)
            or jnp.issubdtype(jnp.asarray(rs_taps).dtype,
                              jnp.complexfloating)):
        # rare complex-taps case: compose the two ops directly
        return upfirdn(rs_taps, lfilter_fir(fir_taps, x), up, down)
    ft = jnp.asarray(fir_taps)
    h_up = jnp.concatenate(
        [ft[:, None], jnp.zeros((t1, up - 1), ft.dtype)],
        axis=1).reshape(-1)[: t1 * up - (up - 1)]
    # tap combination at full f32 (a default-precision conv may run TF32)
    h_comb = jnp.convolve(h_up, jnp.asarray(rs_taps),
                          precision=jax.lax.Precision.HIGHEST)
    n_out = get_upfirdn_size(x.shape[-1], t2, up, down)  # chain-equivalent
    full = upfirdn(h_comb, x, up, down)
    return full[..., :n_out]


def fir_upfirdn_planes_flat(fir_taps: jnp.ndarray, rs_taps: jnp.ndarray,
                            re: jnp.ndarray, im: jnp.ndarray,
                            up: int, down: int):
    """Flat-plane fused FIR + resample chain (same numbers as
    ``fir_upfirdn`` on ``re + 1j*im``).

    ``re``/``im`` are 1-D float32 quadrature planes; returns 1-D output
    planes of the chain (length = the two-op chain's output). The complex
    array never materializes, and only the chain-length output is computed
    (``fir_upfirdn`` computes the full-conv tail and slices it off). Real
    taps only (the production chain; complex taps take the composed ops in
    ``fir_upfirdn``).
    """
    t2 = rs_taps.shape[-1]
    t1 = fir_taps.shape[-1]
    concrete = not (isinstance(fir_taps, jax.core.Tracer)
                    or isinstance(rs_taps, jax.core.Tracer))
    if concrete:
        # HOST tap combination: concrete taps fold at trace time and the
        # band matrix embeds as a program constant (with taps traced, the
        # combine + band-matrix build re-runs inside every call of a loop).
        hu = np.zeros(t1 * up - (up - 1), np.float64)
        hu[::up] = np.asarray(fir_taps, dtype=np.float64)
        h_comb = np.convolve(hu, np.asarray(rs_taps, dtype=np.float64))
    else:
        ft = jnp.asarray(fir_taps)
        h_up = jnp.concatenate(
            [ft[:, None], jnp.zeros((t1, up - 1), ft.dtype)],
            axis=1).reshape(-1)[: t1 * up - (up - 1)]
        h_comb = jnp.convolve(h_up, jnp.asarray(rs_taps),
                              precision=jax.lax.Precision.HIGHEST)
    n_out = get_upfirdn_size(re.shape[-1], t2, up, down)
    h32 = (h_comb.astype(np.float32) if concrete
           else h_comb.astype(jnp.float32))
    planes = jnp.stack([re.astype(jnp.float32), im.astype(jnp.float32)])
    y = _upfirdn_poly_planes(planes, jnp.asarray(h32), up, down, n_out)
    return y[0], y[1]


class StreamUpfirdn:
    """Streaming upfirdn with delay memory (reference
    CupyKernelFilter.run_upfirdn, filterRoutines.py:382): each block is
    prepended with the previous block's tail; the warm-up region is skipped so
    contiguous blocks concatenate seamlessly."""

    def __init__(self, taps, up: int, down: int, memory: int,
                 dtype=jnp.complex64):
        self.taps = jnp.asarray(taps)
        self.up = int(up)
        self.down = int(down)
        self.memory = int(memory)
        self.dtype = jnp.dtype(dtype)
        self.delay = jnp.zeros(self.memory, dtype=self.dtype)

    def reset(self):
        self.delay = jnp.zeros_like(self.delay)

    def resample(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=self.dtype)
        xext = jnp.concatenate([self.delay, x])
        out = upfirdn(self.taps, xext, self.up, self.down)
        self.delay = x[-self.memory:]
        skip = self.memory * self.up // self.down
        length = x.shape[-1] * self.up // self.down
        return out[skip: skip + length]


def resample_factor_wizard(fs: int, rsfs: int) -> tuple[int, int]:
    """Smallest integer (up, down) factors taking sample rate ``fs`` to
    ``rsfs`` (reference resampleFactorWizard, filterRoutines.py:1090)."""
    g = math.gcd(int(fs), int(rsfs))
    return int(rsfs) // g, int(fs) // g


# ---------------------------------------------------------------------------
# Moving sums / averages
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("length", "sum_instead"))
def moving_average(x: jnp.ndarray, length: int, sum_instead: bool = False) -> jnp.ndarray:
    """Causal moving average (or sum) with output length == input length,
    zero-padded at the front — lfilter(ones(L)/L, 1, x) semantics (reference
    cupyMovingAverage, filterRoutines.py:1167; movingAverage kernel,
    custom_kernels/filter.cu:291). Works row-wise on 2-D input (the
    multiMovingAverage variant, filterRoutines.py:1129)."""
    ones = jnp.ones(length, dtype=real_dtype_for(x.dtype))
    squeeze = x.ndim == 1
    x2 = jnp.atleast_2d(x)
    window = jax.vmap(
        lambda r: _conv_causal_matmul(ones.astype(r.dtype), r))(x2)
    out = window if sum_instead else window / length
    out = out.astype(x.dtype)
    return out[0] if squeeze else out


multi_moving_average = moving_average  # row-wise by construction


@functools.partial(jax.jit, static_argnames=("length", "sum_instead"))
def complex_moving_sum(x: jnp.ndarray, length: int, sum_instead: bool = True) -> jnp.ndarray:
    """|moving window sum|^2 of a complex signal over forward windows,
    output length n - L + 1, float32 (reference cupyComplexMovingSum,
    filterRoutines.py:1206; movingComplexSum kernel writes |sum|^2,
    custom_kernels/filter.cu:436)."""
    ones = jnp.ones(length, dtype=x.dtype)
    # forward window sum == causal conv evaluated from index L-1 on
    window = _conv_causal_matmul(ones, x)[length - 1:]
    if not sum_instead:
        window = window / length
    mag_sq = window.real * window.real + window.imag * window.imag
    return mag_sq.astype(real_dtype_for(x.dtype))


# ---------------------------------------------------------------------------
# Median filter
# ---------------------------------------------------------------------------

# window-matrix footprint cap for the one-shot medfilt path; larger inputs
# stream fixed-size chunks through lax.map so peak memory stays O(chunk * k)
_MEDFILT_ELEMS = 1 << 23


@functools.partial(jax.jit, static_argnames=("kernel_size",))
def medfilt(x: jnp.ndarray, kernel_size: int) -> jnp.ndarray:
    """1-D median filter with zero padding, scipy.signal.medfilt semantics
    (the reference burst detector's GPU medfilt: cupyx medfilt at
    filterRoutines.py:805; "~1000x GPU" claim :1068).

    Short inputs gather the (n, k) sliding-window matrix in one shot; long
    inputs stream static-shape chunks through ``lax.map`` so the window
    matrix never exceeds ~64 MiB — a 100M-sample capture with a 1k-tap
    kernel runs in bounded memory instead of materializing an O(n*k) array.
    """
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    half = kernel_size // 2
    n = x.shape[-1]
    xp = jnp.pad(x, (half, half))
    if n * kernel_size <= _MEDFILT_ELEMS:
        idx = jnp.arange(n)[:, None] + jnp.arange(kernel_size)[None, :]
        return jnp.median(xp[idx], axis=-1).astype(x.dtype)

    chunk = max(128, _MEDFILT_ELEMS // kernel_size)
    nchunks = -(-n // chunk)
    # pad so every chunk's window segment is in range (trimmed afterwards)
    xpp = jnp.pad(xp, (0, nchunks * chunk - n))
    win = jnp.arange(chunk)[:, None] + jnp.arange(kernel_size)[None, :]

    def one(start):
        seg = jax.lax.dynamic_slice(
            xpp, (start,), (chunk + kernel_size - 1,))
        return jnp.median(seg[win], axis=-1)

    out = jax.lax.map(one, jnp.arange(nchunks) * chunk).reshape(-1)[:n]
    return out.astype(x.dtype)
