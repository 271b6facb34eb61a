"""Shift-sharded cross-correlation / CAF search.

The mesh replacement for the reference's shift-striped CPU threading
(GroupXcorrFFT.xcorrThreads, /root/reference/xcorrRoutines.py:1114-1135;
IppXcorrFFT.cpp:95-119): the shift axis is embarrassingly parallel, so shifts
are sharded across the mesh with shard_map — each device gathers its own rx
slices (rx is replicated; slices stay local) and runs the same batched
gather->FFT->argmax pipeline as the single-chip path. Peak reduction uses an
all-gather of per-device scalar peaks (negligible bytes between devices).

The jitted shard_map programs are CACHED per (mesh, geometry): building a
fresh closure per call made every invocation recompile (~seconds), which
poisoned the round-3 weak-scaling harness before it poisoned anything else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from pydsproutines_tpu.ops.xcorr import _fast_xcorr_impl, _uniform_step


@functools.lru_cache(maxsize=128)
def _xcorr_fn(mesh, axis, n, step, bs, freqsearch, abs_result):
    local = functools.partial(
        _fast_xcorr_impl, n=n, freqsearch=freqsearch, output_caf=False,
        abs_result=abs_result, batch_size=bs, step=step)
    spec_out = (P(axis), P(axis)) if freqsearch else P(axis)
    return jax.jit(jax.shard_map(
        lambda c, r, s: local(c, r, s),
        mesh=mesh, in_specs=(P(), P(), P(axis)), out_specs=spec_out,
        check_vma=False))


def _split(shifts, mesh, axis, batch_size):
    step = _uniform_step(shifts)
    shifts = jnp.asarray(shifts)
    nper = shifts.shape[0] // mesh.shape[axis]
    if nper * mesh.shape[axis] != shifts.shape[0]:
        raise ValueError("len(shifts) must divide evenly over the mesh axis")
    return step, shifts, int(min(batch_size, nper))


def sharded_fast_xcorr(cutout: jnp.ndarray, rx: jnp.ndarray,
                       shifts: jnp.ndarray, mesh: jax.sharding.Mesh,
                       axis: str = "dsp", freqsearch: bool = True,
                       abs_result: bool = True, batch_size: int = 128):
    """fast_xcorr with the shift axis sharded over ``mesh[axis]``.

    ``len(shifts)`` must be divisible by the mesh axis size. Returns the same
    outputs as fast_xcorr (QF^2 [+ freq bins]), gathered across devices.
    """
    step, shifts, bs = _split(shifts, mesh, axis, batch_size)
    fn = _xcorr_fn(mesh, axis, int(cutout.shape[-1]), step, bs,
                   bool(freqsearch), bool(abs_result))
    return fn(cutout, rx, shifts)


@functools.lru_cache(maxsize=128)
def _caf_peak_fn(mesh, axis, n, step, bs):
    def local(c, r, s):
        qf2, freqs = _fast_xcorr_impl(c, r, s, n=n, freqsearch=True,
                                      output_caf=False, abs_result=True,
                                      batch_size=bs, step=step)
        i = jnp.argmax(qf2)
        # gather every device's local peak triple (scalars only on the wire)
        peaks = jax.lax.all_gather(qf2[i], axis)
        sbest = jax.lax.all_gather(s[i], axis)
        fbest = jax.lax.all_gather(freqs[i], axis)
        j = jnp.argmax(peaks)
        return peaks[j], sbest[j], fbest[j]

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P(axis)),
        out_specs=(P(), P(), P()), check_vma=False))


def sharded_caf_peak(cutout: jnp.ndarray, rx: jnp.ndarray,
                     shifts: jnp.ndarray, mesh: jax.sharding.Mesh,
                     axis: str = "dsp", batch_size: int = 128):
    """Global CAF peak with minimal cross-device traffic: each device reduces
    its own shift range to (best QF^2, best shift, best freq bin) and only
    those scalars cross devices (all-gather + argmax).

    Returns (qf2_peak, best_shift, best_freq_bin) as scalars.
    """
    step, shifts, bs = _split(shifts, mesh, axis, batch_size)
    fn = _caf_peak_fn(mesh, axis, int(cutout.shape[-1]), step, bs)
    return fn(cutout, rx, shifts)
