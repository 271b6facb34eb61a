"""WOLA (weighted overlap-add) polyphase channelizer.

Reference semantics: /root/reference/filterRoutines.py:578 (``wola``) and the
threaded C DLLs (cpuWolaDll.c:107, multiChannelWola.c:112):

    out[nprime, :] = N * ifft( dft_in )        with
    dft_in[a] = sum_b x[nprime*Dec - (b*N + a)] * f_tap[b*N + a]

for nprime in [0, floor(len(x)/Dec)), with x implicitly zero before index 0,
and — when N == 2*Dec — a phase correction that negates the odd channels of
odd output rows (filterRoutines.py:627-629, cpuWolaDll.c:87-94).

Design: instead of striping ``nprime`` across CPU threads, all output rows
are computed at once — a polyphase fold over shifted row blocks of the input
(one fused elementwise pass) and one batched IFFT across rows. The streaming
``Channeliser`` keeps the reference's delay/warm-up-discard semantics so block
outputs concatenate seamlessly. Channel/time sharding over a device mesh lives
in pydsproutines_tpu.parallel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pydsproutines_tpu.utils.dtypes import real_dtype_for
from pydsproutines_tpu.utils.freq import make_freq


@functools.partial(jax.jit, static_argnames=("dec", "n"), inline=True)
def wola(f_tap: jnp.ndarray, x: jnp.ndarray, dec: int, n: int | None = None,
         row_offset=0) -> jnp.ndarray:
    """WOLA channelize ``x`` into ``n`` channels decimated by ``dec``.

    Matches the reference pure-python wola() (filterRoutines.py:578)
    including the odd-row phase flip for n == 2*dec. f_tap length must be an
    integer multiple of n; n must equal dec or 2*dec.

    ``row_offset`` shifts the parity of the odd-row phase flip: when
    processing a block whose first output row has global index r0, pass
    ``row_offset=r0`` so streamed/sharded blocks flip the same rows the
    whole-signal computation would. (The reference's streaming C path flips by
    local row index, which desynchronizes across blocks when the warm-up row
    count is odd — this is a deliberate correctness fix.)
    """
    if n is None:
        n = dec
    if n != dec and n != 2 * dec:
        raise ValueError("Only N == Dec or N == 2*Dec supported (as reference).")
    L = f_tap.shape[-1]
    if L % n != 0:
        raise ValueError("Filter tap length must be an integer multiple of N.")

    nprime_pts = x.shape[-1] // dec
    out = jnp.fft.ifft(_wola_fold(f_tap, x, dec, n, nprime_pts), axis=-1) * n

    if n == 2 * dec:
        # negate odd channels on (globally) odd rows
        row_sign = jnp.where((jnp.arange(nprime_pts) + row_offset) % 2 == 1,
                             -1.0, 1.0)
        chan_odd = (jnp.arange(n) % 2 == 1)
        flip = jnp.where(chan_odd[None, :], row_sign[:, None], 1.0)
        out = out * flip.astype(out.dtype)
    return out.astype(x.dtype)


@functools.partial(jax.jit, static_argnames=("dec", "n"), inline=True)
def wola_planes(f_tap: jnp.ndarray, re: jnp.ndarray, im: jnp.ndarray,
                dec: int, n: int | None = None, row_offset=0):
    """Quadrature-plane WOLA channelize: float32 planes in, planes out.

    Identical numbers to ``wola(f_tap, re + 1j*im, ...)``; ``wola`` remains
    the drop-in complex-API surface (reference filterRoutines.py:578).

    Returns ``(out_re, out_im)``, each (len(re)//dec, n) float32.
    """
    out = wola(f_tap, jax.lax.complex(re.astype(jnp.float32),
                                      im.astype(jnp.float32)),
               dec, n, row_offset=row_offset)
    return jnp.real(out), jnp.imag(out)


@functools.partial(jax.jit, static_argnames=("dec", "n"), inline=True)
def wola_planes_flat(f_tap: jnp.ndarray, re: jnp.ndarray, im: jnp.ndarray,
                     dec: int, n: int | None = None, row_offset=0):
    """Flat-plane WOLA channelize.

    ``re``/``im`` are 1-D float32 quadrature planes of the input samples;
    returns 1-D planes holding the row-major (rows, n) channel matrix —
    bit-identical bytes to ``wola_planes``'s 2-D outputs, and exactly what
    a host consumer sees after ``np.asarray(...).reshape(rows, n)``.
    """
    o_re, o_im = wola_planes(f_tap, re, im, dec, n, row_offset=row_offset)
    return o_re.reshape(-1), o_im.reshape(-1)


def _wola_fold(f_tap, x, dec, n, rows):
    """Polyphase fold: dft_in[r, a] = sum_b x[r*dec - b*n - a] * h[b*n + a]
    with x zero before index 0, for n == q*dec (q in {1, 2}).

    z[r, a] = x[r*dec - a] is a reversed length-n window ending at r*dec:
    the concatenation of q consecutive dec-sample row blocks of the
    left-padded input, flipped. Tap block b then reads z shifted down by
    b*q rows, so the fold is B shifted multiply-adds that XLA fuses into one
    elementwise pass (no window matrix, no matmul).
    """
    B = f_tap.shape[-1] // n
    q = n // dec
    tdt = (x.dtype if jnp.issubdtype(f_tap.dtype, jnp.complexfloating)
           else real_dtype_for(x.dtype))
    taps = f_tap.astype(tdt).reshape(B, n)
    xs = jnp.concatenate([jnp.zeros(n - 1, x.dtype), x[: rows * dec],
                          jnp.zeros(q * dec - n + 1, x.dtype)])
    xb = xs.reshape(rows + q, dec)
    z = jnp.flip(jnp.concatenate([xb[i: i + rows] for i in range(q)],
                                 axis=1), axis=1)
    zp = jnp.concatenate([jnp.zeros(((B - 1) * q, n), x.dtype), z])
    acc = None
    for b in range(B):
        off = (B - 1 - b) * q
        term = zp[off: off + rows] * taps[b]
        acc = term if acc is None else acc + term
    return acc


class Channeliser:
    """Streaming WOLA channelizer (reference Channeliser,
    filterRoutines.py:638): keeps a filter-length delay line, prepends it each
    call, and discards the first len(f_tap)/Dec warm-up rows so consecutive
    blocks concatenate exactly.
    """

    def __init__(self, num_taps: int | None = None, num_channels: int = 64,
                 dec: int | None = None, f_tap=None, dtype=jnp.complex64):
        if dec is None:
            dec = num_channels
        self.dec = int(dec)
        self.num_channels = int(num_channels)
        if f_tap is None:
            from scipy import signal as sps
            f_tap = sps.firwin(num_taps, 1.0 / dec)
        self.f_tap = jnp.asarray(f_tap, dtype=jnp.float32)
        self.dtype = jnp.dtype(dtype)
        if self.f_tap.shape[-1] % self.num_channels != 0:
            raise ValueError("numTaps must be a multiple of numChannels.")
        self.jump = int(self.f_tap.shape[-1] // self.dec)
        self.reset()

    def reset(self):
        self.delay = jnp.zeros(self.f_tap.shape[-1], dtype=self.dtype)
        self._samples_consumed = 0

    def channelise(self, x: jnp.ndarray) -> jnp.ndarray:
        """Channelize one block; returns (floor(len(x)/dec), num_channels).

        Requires len(x) to be a multiple of dec for seamless streaming (the
        reference C path requires the same of its input length).
        """
        x = jnp.asarray(x, dtype=self.dtype)
        y = jnp.concatenate([self.delay, x])
        # local row i <-> global output row (consumed/dec) - jump + i, so the
        # N == 2*Dec phase flip stays aligned with the whole-signal result.
        row_offset = self._samples_consumed // self.dec - self.jump
        channels = wola(self.f_tap, y, self.dec, self.num_channels,
                        row_offset=row_offset)
        self.delay = x[-self.f_tap.shape[-1]:]
        self._samples_consumed += int(x.shape[-1])
        return channels[self.jump:, :]

    def channel_freqs(self, fs: float = 1.0):
        """Centre frequency of each channel (reference channelFreqs)."""
        return make_freq(self.num_channels, fs)

    def channel_fs(self, fs: float = 1.0) -> float:
        """Per-channel output sampling rate (reference channelFs)."""
        return fs / self.dec
