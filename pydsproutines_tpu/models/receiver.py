"""Flagship end-to-end receiver pipeline.

One jitted step covering the reference's implied signal chain
(SURVEY.md §3.6: bin files -> Channeliser -> BurstDetector ->
xcorr -> fineFreqTimeSearch -> ...):

    wideband block -> WOLA channelize -> strongest-channel select ->
    sliding xcorr with frequency scan against a template -> CAF peak ->
    demod (eye-opening + phase lock + symbol map) at the peak.

All shapes are static; the channel/peak selections are traced gathers. The
step takes and returns real arrays (complex formed internally).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.ops.wola import wola
from pydsproutines_tpu.ops.xcorr import _fast_xcorr_impl
from pydsproutines_tpu.ops.demod import get_eye_opening, lock_phase, map_syms


class WidebandReceiver:
    """Channelize -> detect -> xcorr -> demod pipeline.

    Parameters
    ----------
    num_channels, dec : WOLA geometry (num_channels == dec here).
    num_taps : channelizer prototype filter length (multiple of num_channels).
    template_len : xcorr template length at channel rate.
    num_shifts : sliding shifts searched at channel rate.
    osr : samples per symbol at channel rate (for the demod stage).
    demod_syms : symbols demodulated at the CAF peak.
    m : PSK order.
    """

    def __init__(self, num_channels: int = 64, num_taps: int = 512,
                 template_len: int = 1024, num_shifts: int = 256,
                 osr: int = 4, demod_syms: int = 128, m: int = 4):
        from scipy import signal as sps
        self.num_channels = int(num_channels)
        self.dec = int(num_channels)
        self.num_taps = int(num_taps)
        self.f_tap = jnp.asarray(
            sps.firwin(num_taps, 1.0 / self.dec), dtype=jnp.float32)
        self.template_len = int(template_len)
        self.num_shifts = int(num_shifts)
        self.osr = int(osr)
        self.demod_syms = int(demod_syms)
        self.m = int(m)

    # -- jittable forward step ------------------------------------------------
    @functools.partial(jax.jit, static_argnums=(0,))
    def step(self, template_ri: jnp.ndarray, rx_ri: jnp.ndarray):
        """One forward step.

        template_ri : (2, template_len) float32 — re/im of the xcorr template
            at channel rate.
        rx_ri : (2, n_wideband) float32 — re/im of the wideband capture.

        Returns (qf2 peak, best shift, best freq bin, per-channel energy,
        demod symbol indices) — all real/int arrays.
        """
        template = jax.lax.complex(template_ri[0], template_ri[1])
        rx = jax.lax.complex(rx_ri[0], rx_ri[1])

        # 1) channelize
        channels = wola(self.f_tap, rx, self.dec, self.num_channels)

        # 2) strongest channel (traced select)
        energy = jnp.mean(channels.real ** 2 + channels.imag ** 2, axis=0)
        best_chan = jnp.argmax(energy)
        x = jnp.take(channels, best_chan, axis=1)

        # 3) sliding xcorr with freq scan
        shifts = jnp.arange(self.num_shifts)
        qf2, freqbins = _fast_xcorr_impl(
            template, x, shifts, n=self.template_len, freqsearch=True,
            output_caf=False, abs_result=True,
            batch_size=min(128, self.num_shifts), step=1)
        ipeak = jnp.argmax(qf2)

        # 4) demod at the peak: grab a static-length slice from the peak
        seg = jax.lax.dynamic_slice(
            x, (ipeak,), (self.demod_syms * self.osr,))
        xeo, _, _ = get_eye_opening(seg, self.osr)
        reimc, _, theta = lock_phase(xeo, self.m)
        syms = map_syms(reimc, self.m)

        return (qf2[ipeak], ipeak, freqbins[ipeak], energy,
                syms.astype(jnp.int32))

    # -- observability --------------------------------------------------------
    def run(self, template_ri: jnp.ndarray, rx_ri: jnp.ndarray) -> dict:
        """One step plus a structured run summary: the metrics dict version
        of the reference's print-based observability (SURVEY.md §5 —
        quality metrics as first-class values)."""
        from pydsproutines_tpu.ops.xcorr import (convert_qf2_to_eff_snr,
                                                 select_xcorr_path)
        qf2, ipeak, fbin, energy, syms = self.step(template_ri, rx_ri)
        energy = np.asarray(energy)
        path, reason = select_xcorr_path(True, False, 1)
        qf2 = float(qf2)
        best_chan = int(np.argmax(energy))
        return {
            "qf2_peak": qf2,
            "eff_snr_db": float(10 * np.log10(max(
                convert_qf2_to_eff_snr(min(qf2, 1 - 1e-9)), 1e-12))),
            "best_shift": int(ipeak),
            "freq_bin": int(fbin),
            "best_channel": best_chan,
            "channel_energy": energy.tolist(),
            "channel_energy_db": (10 * np.log10(
                np.maximum(energy, 1e-30))).round(2).tolist(),
            "demod_syms": np.asarray(syms).tolist(),
            "xcorr_path": path,
            "xcorr_path_reason": reason,
            "config": {
                "num_channels": self.num_channels,
                "num_taps": self.num_taps,
                "template_len": self.template_len,
                "num_shifts": self.num_shifts,
                "osr": self.osr, "m": self.m,
            },
        }

    # -- convenience ----------------------------------------------------------
    def example_inputs(self, seed: int = 0):
        """Host-side example (template_ri, rx_ri) with a planted burst."""
        rng = np.random.default_rng(seed)
        n_wide = (self.num_shifts + self.template_len
                  + self.demod_syms * self.osr + self.num_taps // self.dec + 8
                  ) * self.dec
        syms = np.exp(1j * (np.pi / 2) * rng.integers(0, 4, self.template_len))
        rx = (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide))
        rx *= 0.1
        # plant the template on channel 1 at shift ~ num_shifts//2
        k = 1
        t = np.arange(n_wide)
        start = (self.num_shifts // 2 + self.num_taps // self.dec) * self.dec
        up = np.zeros(n_wide, dtype=complex)
        up[start: start + self.template_len * self.dec: self.dec] = syms
        rx = rx + up * np.exp(1j * 2 * np.pi * (k / self.num_channels) * t)
        template_ri = np.stack([syms.real, syms.imag]).astype(np.float32)
        rx_ri = np.stack([rx.real, rx.imag]).astype(np.float32)
        return jnp.asarray(template_ri), jnp.asarray(rx_ri)
