"""Synthetic signal creation.

Re-expresses the semantics of the reference's signalCreationRoutines
(/root/reference/signalCreationRoutines.py: randBits :20, symsFromBits :24,
randPSKsyms :47, randnoise :72, addSigToNoise :107, addManySigToNoise :148,
makeCPFSKsyms :220, makePulsedCPFSKsyms :254, propagateSignal :296,
propagateSignalExact :331) in functional JAX: explicit PRNG keys instead of
global numpy state, jit-friendly static shapes, and batched/vmap-able bodies.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.utils.dtypes import real_dtype_for
from pydsproutines_tpu.utils.freq import make_freq, tone

# Constellations indexed by symbol value (monotonically increasing angle is NOT
# used here — the reference uses these specific orderings; symsFromBits
# reference: signalCreationRoutines.py:24).
_SQ2 = 1.0 / np.sqrt(2.0)
PSK_CONSTELLATIONS = {
    2: np.array([1, -1], dtype=np.complex128),
    4: np.array([1, 1j, -1, -1j], dtype=np.complex128),
    8: np.array(
        [1, (1 + 1j) * _SQ2, 1j, (-1 + 1j) * _SQ2,
         -1, (-1 - 1j) * _SQ2, -1j, (1 - 1j) * _SQ2],
        dtype=np.complex128,
    ),
}


def rand_bits(key, length: int, m: int) -> jnp.ndarray:
    """Random symbols in [0, m) as uint8 (reference randBits)."""
    return jax.random.randint(key, (length,), 0, m, dtype=jnp.uint8)


def syms_from_bits(bits: jnp.ndarray, m: int, dtype=jnp.complex64) -> jnp.ndarray:
    """Map integer symbol values to PSK constellation points."""
    const = jnp.asarray(PSK_CONSTELLATIONS[m], dtype=dtype)
    return const[bits]


def rand_psk_syms(key, length: int, m: int, dtype=jnp.complex64):
    """Random m-ary PSK symbols. Returns (syms, bits)."""
    bits = rand_bits(key, length, m)
    return syms_from_bits(bits, m, dtype), bits


def randnoise(key, length: int, bw_signal: float, chn_bw: float,
              snr_inband_linear: float, sig_pwr: float = 1.0,
              dtype=jnp.complex64) -> jnp.ndarray:
    """Complex AWGN calibrated so a signal of power ``sig_pwr`` and bandwidth
    ``bw_signal`` in a channel of bandwidth ``chn_bw`` sees the requested
    in-band SNR (reference randnoise, signalCreationRoutines.py:72)."""
    rdt = real_dtype_for(dtype)
    kr, ki = jax.random.split(key)
    basic = (jax.random.normal(kr, (length,), dtype=rdt)
             + 1j * jax.random.normal(ki, (length,), dtype=rdt)) / np.sqrt(2.0)
    scale = np.sqrt(sig_pwr) * np.sqrt(1.0 / snr_inband_linear) * np.sqrt(chn_bw / bw_signal)
    return (basic * scale).astype(dtype)


def add_sig_to_noise(key, signal: jnp.ndarray, noise_len: int | None = None,
                     sig_start_idx: int = 0, bw_signal: float = 1.0,
                     chn_bw: float = 1.0, snr_inband_linear: float = np.inf,
                     sig_pwr: float = 1.0, fshift: float | None = None):
    """Place ``signal`` into a noisy background at ``sig_start_idx`` with an
    optional frequency shift (reference addSigToNoise).

    Returns (noise, rx) or (noise, rx, tone) when ``fshift`` is given.
    """
    if noise_len is None:
        noise_len = signal.shape[-1]
    if np.isinf(snr_inband_linear):
        noise = jnp.zeros(noise_len, dtype=signal.dtype)
    else:
        noise = randnoise(key, noise_len, bw_signal, chn_bw, snr_inband_linear,
                          sig_pwr, dtype=signal.dtype)
    rx = jnp.zeros(noise_len, dtype=signal.dtype)
    rx = jax.lax.dynamic_update_slice(rx, signal, (sig_start_idx,))
    rx = rx + noise
    if fshift is not None:
        t = tone(noise_len, fshift, chn_bw, dtype=signal.dtype)
        return noise, rx * t, t
    return noise, rx


def add_many_sig_to_noise(key, noise_len: int, sig_start_idx_list, signal_list,
                          bw_signal: float, chn_bw: float,
                          snr_inband_linear_list, fshifts=None):
    """Sum many scaled signal copies into one calibrated noise floor
    (reference addManySigToNoise, signalCreationRoutines.py:148). Signals are
    assumed unit power; relative SNRs are produced by amplitude scaling against
    the first SNR in the list."""
    snrs = list(snr_inband_linear_list)
    noise = randnoise(key, noise_len, bw_signal, chn_bw, snrs[0], 1.0,
                      dtype=jnp.asarray(signal_list[0]).dtype)
    rx = jnp.zeros(noise_len, dtype=noise.dtype)
    for i, (start, sig) in enumerate(zip(sig_start_idx_list, signal_list)):
        scaled = jnp.asarray(sig) * np.sqrt(snrs[i] / snrs[0])
        row = jnp.zeros(noise_len, dtype=noise.dtype)
        row = jax.lax.dynamic_update_slice(row, scaled.astype(noise.dtype), (int(start),))
        if fshifts is not None:
            row = row * tone(noise_len, fshifts[i], chn_bw, dtype=noise.dtype)
        rx = rx + row
    return noise, rx + noise


def make_cpfsk_syms(bits: jnp.ndarray, baud: float, m: int = 2, h: float = 0.5,
                    up: int = 8, phase: float = 0.0, dtype=jnp.complex64):
    """CPFSK with a rectangular pulse of length one symbol
    (reference makeCPFSKsyms, signalCreationRoutines.py:220).

    Returns (sig, fs, data) where data = bits*m - 1.
    """
    rdt = real_dtype_for(dtype)
    T = 1.0 / baud
    fs = baud * up
    nbits = bits.shape[0]
    data = bits.astype(jnp.int8) * m - 1

    n = jnp.arange(nbits * up)
    i_list = n // up
    t_list = n.astype(rdt) / fs
    # phase accumulator: cumulative sum of previous symbols
    accum = jnp.concatenate([jnp.zeros(1, dtype=jnp.int32),
                             jnp.cumsum(data.astype(jnp.int32))])[:nbits]
    a_list = jnp.repeat(accum, up).astype(rdt)

    theta = (data[i_list].astype(rdt) * (np.pi * h) * (t_list - i_list.astype(rdt) * T) / T
             + np.pi * h * a_list + phase)
    sig = jnp.exp(1j * theta).astype(dtype)
    return sig, fs, data


def make_pulsed_cpfsk_syms(bits: jnp.ndarray, baud: float, g: jnp.ndarray | None = None,
                           m: int = 2, h: float = 0.5, up: int = 8,
                           phase: float = 0.0, dtype=jnp.complex64):
    """CPFSK with an arbitrary phase pulse shape ``g`` applied convolutionally
    before phase accumulation (reference makePulsedCPFSKsyms,
    signalCreationRoutines.py:254). Returns (sig, fs, data, css) with the full
    convolution length, as in the reference."""
    rdt = real_dtype_for(dtype)
    if g is None:
        g = jnp.ones(up, dtype=rdt) / (2 * up)
    g = jnp.asarray(g, dtype=rdt)
    fs = baud * up
    data = bits.astype(jnp.int8) * m - 1

    theta = jnp.zeros(bits.shape[0] * up + 1, dtype=rdt)
    theta = theta.at[1::up].set(data.astype(rdt))
    c = jnp.convolve(theta, g)  # full convolution
    cs = jnp.cumsum(c)
    css = cs * (2 * np.pi * h) + phase
    sig = jnp.exp(1j * css).astype(dtype)
    return sig, fs, data, css


def propagate_signal(sig: jnp.ndarray, time, fs: float, freq: float | None = None):
    """Sub-sample time shift via FFT phase ramp, with optional frequency shift
    (reference propagateSignal, signalCreationRoutines.py:296).

    ``sig`` may be 1-D or 2-D (rows independently shifted); ``time`` is a
    scalar or per-row array of shifts in seconds. Returns the shifted signal,
    or (shifted*tone, tone) when freq is given.
    """
    sig = jnp.atleast_2d(sig)
    t = jnp.atleast_1d(jnp.asarray(time))
    n = sig.shape[-1]
    rdt = real_dtype_for(sig.dtype)
    sigfft = jnp.fft.fft(sig, axis=-1)
    f = make_freq(n, fs, dtype=jnp.float32 if rdt == np.float32 else jnp.float64)
    mat = jnp.exp(-1j * 2 * jnp.pi * f[None, :] * t[:, None]).astype(sigfft.dtype)
    result = jnp.fft.ifft(mat * sigfft, axis=-1).astype(sig.dtype)
    result = result[0] if result.shape[0] == 1 and jnp.ndim(time) == 0 else result
    if freq is None:
        return result
    tn = tone(n, freq, fs, dtype=sig.dtype)
    return result * tn, tn


def propagate_signal_exact(sig: jnp.ndarray, tau: jnp.ndarray, fs: float,
                           f_c: float = 0.0):
    """Exact per-sample delay resampling via the DFT interpolation formula
    (reference propagateSignalExact, signalCreationRoutines.py:331), expressed
    as one (N, N) matrix product instead of an O(N^2)
    python loop: result[n] = (1/N) sum_k exp(1j*2*pi*(n/fs - tau[n])*f_k) X[k].
    """
    n = sig.shape[-1]
    rdt = real_dtype_for(sig.dtype)
    fftsig = jnp.fft.fft(sig)
    f = make_freq(n, fs, dtype=jnp.float32 if rdt == np.float32 else jnp.float64)
    ntau = jnp.arange(n, dtype=f.dtype) / fs - tau.astype(f.dtype)
    basis = jnp.exp(1j * 2 * jnp.pi * ntau[:, None] * f[None, :]).astype(fftsig.dtype)
    result = (basis @ fftsig) / n
    carrier = jnp.exp(-1j * 2 * jnp.pi * f_c * tau).astype(fftsig.dtype)
    return (result * carrier).astype(sig.dtype)
