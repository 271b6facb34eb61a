"""Group cross-correlation: coherent CAF combining of disjoint burst groups,
and multi-template FFT matched filtering.

Reference semantics: /root/reference/xcorrRoutines.py (GroupXcorr :852,
GroupXcorrCZT :957, GroupXcorrFFT :1047 with threaded/GPU variants,
TemplateCrossCorrelator :277) plus the native ports
(pybinds/ippGroupXcorrCZT/GroupXcorrCZT.cpp, cython_ext/CyGroupXcorrFFT).

The group xcorr evaluates, for each candidate shift and scan frequency f,

    | sum_g exp(-j*2*pi*f*start_g/fs) * CZT_or_FFT( rx[shift+start_g : ...]
          * conj(y_g) )(f) |^2  /  sum_g ||rx group||^2  /  ||y||^2

i.e. per-group product spectra phase-aligned by the group start times and
summed coherently.

Design: groups are padded to a common length and stacked, so a
(shift-chunk x group) batch goes through ONE batched FFT/CZT; the coherent
group combine is a matmul-like reduction; shift chunks stream through
``lax.map``. The reference's thread-striped shift partitioning becomes mesh
sharding (pydsproutines_tpu.parallel.xcorr applies unchanged since shifts are
the outer axis).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pydsproutines_tpu.ops.spectral import CZT
from pydsproutines_tpu.ops.xcorr import _chunked_map, _abs_sq
from pydsproutines_tpu.utils.dtypes import real_dtype_for
from pydsproutines_tpu.utils.fftlen import next_fast_len
from pydsproutines_tpu.utils.freq import make_freq


def _stack_groups(y: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                  auto_conj: bool) -> np.ndarray:
    max_len = int(np.max(lengths))
    ystack = np.zeros((len(starts), max_len), dtype=np.asarray(y).dtype)
    for i, (s, l) in enumerate(zip(starts, lengths)):
        ystack[i, :l] = np.asarray(y)[s: s + l]
    return np.conj(ystack) if auto_conj else ystack


class GroupXcorrCZT:
    """Group xcorr over a CZT frequency grid (reference GroupXcorrCZT,
    xcorrRoutines.py:957; C++ pybinds/ippGroupXcorrCZT).

    Returns the full (shifts x freq bins) CAF from :meth:`xcorr`.
    """

    def __init__(self, y, starts, lengths, f1: float, f2: float,
                 bin_width: float, fs: float, auto_conj: bool = True,
                 auto_zero_starts: bool = True, dtype=jnp.complex64):
        starts = np.asarray(starts)
        lengths = np.asarray(lengths)
        assert starts.size == lengths.size
        if auto_zero_starts:
            starts = starts - starts[0]
        self.starts = starts
        self.lengths = lengths
        self.num_groups = starts.size
        self.fs = float(fs)
        self.max_length = int(np.max(lengths))

        # All plan constants stay HOST numpy, closed over by the per-instance
        # jitted closure (embedded as program constants).
        ystack = _stack_groups(np.asarray(y), starts, lengths, auto_conj)
        self.ystack = ystack.astype(np.dtype(dtype))
        self.ystack_norm_sq = float(np.linalg.norm(ystack.flatten()) ** 2)

        self.plan = CZT(self.max_length, f1, f2, bin_width, fs, dtype=dtype)
        freqs = self.plan.freqs()
        self.czt_freq = freqs
        # per-group phase alignment exp(-j*2*pi*f*start/fs)
        phases = np.exp(-2j * np.pi * freqs[None, :] * starts[:, None] / fs)
        self.group_phases = phases.astype(np.dtype(dtype))
        # mask for valid samples per group row (groups padded to max_length)
        self.group_mask = np.arange(self.max_length)[None, :] < lengths[:, None]
        self._fns = {}

    def xcorr(self, rx: jnp.ndarray, shifts=None, batch_size: int = 32,
              step: int | None = None):
        """CAF over ``shifts``; returns ((num_shifts, k) QF^2 grid, czt
        freqs).

        ``step``: declare the shifts' uniform stride when calling from
        INSIDE a jit — traced shift arrays cannot be inspected host-side
        (np.asarray on a tracer raises), so without it the sweep silently
        takes the generic-gather tier. Host numpy/concrete shifts are
        detected automatically."""
        from pydsproutines_tpu.ops.xcorr import _uniform_step
        if shifts is None:
            shifts = jnp.arange(
                rx.shape[-1] - (int(self.starts[-1]) + int(self.lengths[-1])) + 1)
        if step is None:
            step = _uniform_step(shifts)
        shifts = jnp.asarray(shifts)
        bs = int(min(batch_size, shifts.shape[0]))
        fn = self._fns.get((bs, step))
        if fn is None:
            ystack, mask, phases = self.ystack, self.group_mask, self.group_phases
            starts = self.starts.astype(np.int32)
            aa, fv, ww = self.plan.aa, self.plan.fv, self.plan.ww_tail
            tones = self.plan.tones
            m, k, nfft = self.max_length, self.plan.k, self.plan.nfft
            ynormsq = self.ystack_norm_sq
            g = starts.size

            def czt_combine(slices):
                """(B, G, m) masked slices -> (B, k) CAF rows."""
                slices = jnp.where(mask, slices, 0)
                rx_norm_sq = jnp.sum(_abs_sq(slices), axis=(-2, -1))
                pdt = slices * ystack
                from pydsproutines_tpu.ops.spectral import (_czt_core,
                                                            _czt_direct)
                if tones is not None:
                    # direct tone-bank matmul: the group phase combine folds
                    # into the same contraction — combined[b, f] =
                    # sum_g sum_t pdt[b,g,t] tones[t,f] phases[g,f]
                    combined = jnp.einsum(
                        "bgt,tf,gf->bf", pdt, jnp.asarray(tones),
                        jnp.asarray(phases),
                        precision=jax.lax.Precision.HIGHEST)
                else:
                    pdtczt = _czt_core(pdt, aa, fv, ww, m, k, nfft)
                    combined = jnp.sum(pdtczt * phases, axis=-2)
                return _abs_sq(combined) / rx_norm_sq[:, None] / ynormsq

            def _impl(rx, shifts):
                if step is not None:
                    halo = (bs - 1) * step

                    def chunk_fn(chunk):
                        # ONE dynamic window per group per chunk; per-shift
                        # rows are static slices of it
                        wins = jax.vmap(lambda s: jax.lax.dynamic_slice(
                            rx, (chunk[0] + s,), (m + halo,)))(
                            jnp.asarray(starts))                 # (G, m+halo)
                        slices = jnp.stack([
                            jax.lax.slice(wins, (0, i * step),
                                          (g, i * step + m))
                            for i in range(bs)])                 # (B, G, m)
                        return czt_combine(slices)
                else:
                    def chunk_fn(chunk):
                        slices = jax.vmap(lambda shift: jax.vmap(
                            lambda s: jax.lax.dynamic_slice(
                                rx, (shift + s,), (m,)))(
                            jnp.asarray(starts)))(chunk)
                        return czt_combine(slices)

                return _chunked_map(chunk_fn, shifts, bs,
                                    step=step)

            fn = self._fns.setdefault((bs, step), jax.jit(_impl))
        return fn(rx, shifts), self.czt_freq


class GroupXcorrFFT:
    """Group xcorr over the FFT frequency grid (reference GroupXcorrFFT,
    xcorrRoutines.py:1047; Cython CyGroupXcorrFFT). All groups share one
    length; returns the (shifts x fftlen) CAF."""

    def __init__(self, ygroups, starts, fs: float, auto_conj: bool = True,
                 fftlen: int | None = None, auto_zero_starts: bool = True,
                 dtype=jnp.complex64):
        ygroups = np.asarray(ygroups)
        starts = np.asarray(starts)
        assert starts.size == ygroups.shape[0]
        if auto_zero_starts:
            starts = starts - starts[0]
        self.starts = starts
        self.num_groups = starts.size
        self.fs = float(fs)
        self.ygroup_len = ygroups.shape[1]
        self.fftlen = int(fftlen) if fftlen is not None else self.ygroup_len
        self.ygroup_norm_sq = float(np.linalg.norm(ygroups.flatten()) ** 2)
        if auto_conj:
            ygroups = np.conj(ygroups)
        # host numpy plan state, embedded as program constants
        self.ygroups = ygroups.astype(np.dtype(dtype))
        fftfreq = np.asarray(make_freq(self.fftlen, fs, dtype=jnp.float64))
        phases = np.exp(-2j * np.pi * fftfreq[None, :] * starts[:, None] / fs)
        self.group_phases = phases.astype(np.dtype(dtype))
        self.fftfreq = fftfreq
        self._fns = {}

    def xcorr(self, rx: jnp.ndarray, shifts=None, batch_size: int = 32,
              step: int | None = None):
        from pydsproutines_tpu.ops.xcorr import _uniform_step
        if shifts is None:
            shifts = jnp.arange(
                rx.shape[-1] - (int(self.starts[-1]) + self.ygroup_len) + 1)
        if step is None:
            step = _uniform_step(shifts)
        shifts = jnp.asarray(shifts)
        bs = int(min(batch_size, shifts.shape[0]))
        fn = self._fns.get((bs, step))
        if fn is None:
            ygroups, phases = self.ygroups, self.group_phases
            starts = self.starts.astype(np.int32)
            n, fftlen = self.ygroup_len, self.fftlen
            ynormsq = self.ygroup_norm_sq
            g = starts.size

            def fft_combine(slices):
                """(B, G, n) slices -> (B, fftlen) CAF rows."""
                rx_norm_sq = jnp.sum(_abs_sq(slices), axis=(-2, -1))
                pdt = slices * ygroups
                pdtfft = jnp.fft.fft(pdt, n=fftlen, axis=-1)
                combined = jnp.sum(pdtfft * phases, axis=-2)
                return _abs_sq(combined) / rx_norm_sq[:, None] / ynormsq

            def _impl(rx, shifts):
                if step is not None:
                    halo = (bs - 1) * step

                    def chunk_fn(chunk):
                        wins = jax.vmap(lambda s: jax.lax.dynamic_slice(
                            rx, (chunk[0] + s,), (n + halo,)))(
                            jnp.asarray(starts))
                        slices = jnp.stack([
                            jax.lax.slice(wins, (0, i * step),
                                          (g, i * step + n))
                            for i in range(bs)])
                        return fft_combine(slices)
                else:
                    def chunk_fn(chunk):
                        slices = jax.vmap(lambda shift: jax.vmap(
                            lambda s: jax.lax.dynamic_slice(
                                rx, (shift + s,), (n,)))(
                            jnp.asarray(starts)))(chunk)
                        return fft_combine(slices)

                return _chunked_map(chunk_fn, shifts, bs, step=step)

            fn = self._fns.setdefault((bs, step), jax.jit(_impl))
        return fn(rx, shifts)


class GroupXcorr:
    """Group xcorr against an explicit frequency list via a tone-bank matmul
    (reference GroupXcorr, xcorrRoutines.py:852). Returns per-shift peak QF^2
    and peak frequency (flattened over the scan list)."""

    def __init__(self, y, starts, lengths, freqs, fs: float,
                 auto_conj: bool = True, auto_zero_starts: bool = True,
                 dtype=jnp.complex64):
        starts = np.asarray(starts)
        lengths = np.asarray(lengths)
        freqs = np.asarray(freqs, dtype=np.float64)
        assert starts.size == lengths.size
        if auto_zero_starts:
            starts = starts - starts[0]
        self.starts = starts
        self.lengths = lengths
        self.num_groups = starts.size
        self.freqs = freqs
        self.fs = float(fs)

        y = np.asarray(y)
        concat = np.hstack([y[s: s + l] for s, l in zip(starts, lengths)])
        if auto_conj:
            concat = np.conj(concat)
        # host numpy plan state, embedded as program constants
        self.yconcat = concat.astype(np.dtype(dtype))
        self.yconcat_norm_sq = float(np.linalg.norm(concat) ** 2)
        # tone bank over the *original sample positions* of the stitched groups
        positions = np.hstack([np.arange(s, s + l)
                               for s, l in zip(starts, lengths)])
        mat = np.exp(-2j * np.pi * freqs[:, None] * positions[None, :] / fs)
        self.freq_mat = mat.astype(np.dtype(dtype))
        # gather indices for stitching rx slices per shift
        self.gather_idx = positions.astype(np.int32)
        self._fns = {}

    def xcorr(self, rx: jnp.ndarray, shifts=None, batch_size: int = 64):
        if shifts is None:
            shifts = jnp.arange(
                rx.shape[-1] - (int(self.starts[-1]) + int(self.lengths[-1])) + 1)
        shifts = jnp.asarray(shifts)
        bs = int(min(batch_size, shifts.shape[0]))
        fn = self._fns.get(bs)
        if fn is None:
            yconcat, freq_mat = self.yconcat, self.freq_mat
            gather_idx, freqs64 = self.gather_idx, self.freqs
            ynormsq = self.yconcat_norm_sq

            def _impl(rx, shifts):
                freqs = jnp.asarray(freqs64, dtype=real_dtype_for(rx.dtype))

                def one_shift(shift):
                    rxconcat = rx[shift + gather_idx]
                    rx_norm_sq = jnp.sum(_abs_sq(rxconcat))
                    p = rxconcat * yconcat
                    pf = jnp.matmul(freq_mat, p,   # tone-bank matmul
                                    precision=jax.lax.Precision.HIGHEST)
                    mag = _abs_sq(pf)
                    i = jnp.argmax(mag)
                    xc = mag[i] / rx_norm_sq / ynormsq
                    return xc, freqs[i]

                return _chunked_map(jax.vmap(one_shift), shifts, bs)

            fn = self._fns.setdefault(bs, jax.jit(_impl))
        return fn(rx, shifts)


class TemplateCrossCorrelator:
    """FFT-domain multi-template correlator with rolling-energy normalization
    (reference TemplateCrossCorrelator, xcorrRoutines.py:277). Returns QF (not
    QF^2), matching the reference."""

    def __init__(self, templates, input_size: int, dtype=jnp.complex64):
        templates = np.asarray(templates)
        if templates.ndim != 2:
            raise ValueError("Templates must be 2D; 1 row per template.")
        self.input_size = int(input_size)
        self.template_len = templates.shape[1]
        rdt = real_dtype_for(jnp.dtype(dtype))
        # host numpy plan state, embedded as program constants
        self.template_norms = np.linalg.norm(templates, axis=1).astype(
            np.dtype(rdt))
        padded = np.zeros((templates.shape[0], input_size), templates.dtype)
        padded[:, : self.template_len] = templates
        self.templateffts_conj = np.conj(
            np.fft.fft(padded, axis=1)).astype(np.dtype(dtype))
        self._fns = {}

    def correlate(self, x: jnp.ndarray, return_max: bool = False):
        if x.shape[-1] != self.input_size:
            raise ValueError(f"x must be length {self.input_size}")
        fn = self._fns.get(bool(return_max))
        if fn is None:
            tfftsconj, tnorms = self.templateffts_conj, self.template_norms
            template_len = self.template_len

            def _impl(x):
                from pydsproutines_tpu.ops.filters import _conv_causal_matmul
                xfft = jnp.fft.fft(x)
                out = jnp.fft.ifft(xfft[None, :] * tfftsconj, axis=-1)
                # rolling input energy over template_len windows (matmul
                # form: XLA's huge-width 1-D conv compiles slowly)
                power = _abs_sq(x)
                ones = jnp.ones(template_len, dtype=power.dtype)
                moving = _conv_causal_matmul(ones, power)[template_len - 1:]
                norms = jnp.sqrt(moving)
                nout = out[:, : x.shape[-1] - template_len + 1] / norms[None, :]
                nout = nout / tnorms[:, None]
                if not return_max:
                    return nout
                mag = jnp.abs(nout)
                idx = jnp.argmax(mag, axis=0)
                best = jnp.take_along_axis(mag, idx[None, :], axis=0)[0]
                return best, idx

            fn = self._fns.setdefault(bool(return_max), jax.jit(_impl))
        return fn(x)


class GroupXcorrCZTPermutations:
    """Group xcorr over template *permutations*: each group's template is
    drawn from a set; per-template correlations are computed once and combined
    per permutation (reference GroupXcorrCZT_Permutations,
    /root/reference/xcorrRoutines.py:1264 — thread/GPU-batched there, one
    batched CZT over all templates per shift chunk here).

    All groups share one template length. After :meth:`xcorr`, call
    :meth:`get_caf` with one template choice per group.
    """

    def __init__(self, ygroups, ygroup_idxs, group_starts, f1: float,
                 f2: float, bin_width: float, fs: float,
                 auto_conj: bool = True, dtype=jnp.complex64):
        ygroups = np.asarray(ygroups)
        ygroup_idxs = np.asarray(ygroup_idxs)
        group_starts = np.asarray(group_starts)
        assert ygroups.shape[0] == ygroup_idxs.size
        assert np.unique(ygroup_idxs).size == group_starts.size
        assert np.all(np.sort(np.unique(ygroup_idxs))
                      == np.arange(group_starts.size))
        self.num_templates = ygroup_idxs.size
        self.num_groups = group_starts.size
        self.group_starts = group_starts
        self.ygroup_idxs = ygroup_idxs
        self.length = ygroups.shape[1]
        self.fs = float(fs)
        if auto_conj:
            ygroups = np.conj(ygroups)
        # host numpy plan state, embedded as program constants
        self.ygroups = ygroups.astype(np.dtype(dtype))
        self.ygroups_energy = np.linalg.norm(ygroups, axis=1) ** 2

        self.plan = CZT(self.length, f1, f2, bin_width, fs, dtype=dtype)
        self.czt_freq = self.plan.freqs()
        phases = np.exp(-2j * np.pi * self.czt_freq[None, :]
                        * group_starts[:, None] / fs)
        # phase per *template* (indexed by its group)
        self.template_phases = phases[ygroup_idxs].astype(np.dtype(dtype))
        self.xc_templates = None
        self.rx_group_norm_sq = None
        self._fns = {}

    def xcorr(self, rx: jnp.ndarray, shifts=None, batch_size: int = 8):
        """Correlate every template at every shift. Stores (T, S, K) complex
        template spectra and (G, S) rx group energies; returns czt_freq."""
        if shifts is None:
            shifts = jnp.arange(
                rx.shape[-1] - (int(self.group_starts[-1]) + self.length) + 1)
        shifts = jnp.asarray(shifts)
        bs = int(min(batch_size, shifts.shape[0]))
        fn = self._fns.get(bs)
        if fn is None:
            ygroups, template_phases = self.ygroups, self.template_phases
            group_starts = self.group_starts.astype(np.int32)
            ygroup_idxs = self.ygroup_idxs.astype(np.int32)
            m, k, nfft = self.length, self.plan.k, self.plan.nfft
            aa, fv, ww = self.plan.aa, self.plan.fv, self.plan.ww_tail
            tones = self.plan.tones

            def _impl(rx, shifts):
                def one_shift(shift):
                    gslices = jax.vmap(
                        lambda s: jax.lax.dynamic_slice(
                            rx, (shift + s,), (m,)))(jnp.asarray(group_starts))
                    rx_norm_sq = jnp.sum(_abs_sq(gslices), axis=-1)     # (G,)
                    tslices = gslices[ygroup_idxs]                      # (T, m)
                    pdt = tslices * ygroups                             # (T, m)
                    from pydsproutines_tpu.ops.spectral import (_czt_core,
                                                                _czt_direct)
                    if tones is not None:
                        pdtczt = _czt_direct(pdt, tones)                # (T, k)
                    else:
                        pdtczt = _czt_core(pdt, aa, fv, ww, m, k, nfft)
                    return pdtczt * template_phases, rx_norm_sq

                return _chunked_map(jax.vmap(one_shift), shifts, bs)

            fn = self._fns.setdefault(bs, jax.jit(_impl))
        xc, rn = fn(rx, shifts)
        # stored transposed to (T, S, K) / (G, S) like the reference
        self.xc_templates = jnp.moveaxis(xc, 0, 1)
        self.rx_group_norm_sq = jnp.moveaxis(rn, 0, 1)
        return self.czt_freq

    def get_caf(self, template_idx) -> jnp.ndarray:
        """Combine one template choice per group into the (S, K) CAF
        (reference getCAF)."""
        template_idx = np.asarray(template_idx)
        assert template_idx.size == self.num_groups
        if self.xc_templates is None:
            raise ValueError("Run xcorr() first.")
        caf_cplx = 0
        rxnormsq = 0
        ynormsq = 0.0
        for group in range(self.num_groups):
            tnum = int(np.argwhere(self.ygroup_idxs == group)[
                template_idx[group]][0])
            caf_cplx = caf_cplx + self.xc_templates[tnum]
            rxnormsq = rxnormsq + self.rx_group_norm_sq[group]
            ynormsq += float(self.ygroups_energy[tnum])
        return _abs_sq(caf_cplx) / rxnormsq[:, None] / ynormsq
