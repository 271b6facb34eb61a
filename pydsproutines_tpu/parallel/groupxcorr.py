"""Shift-sharded group cross-correlation.

The reference partitions group-xcorr shifts across CPU threads (contiguous
blocks in the C++ GroupXcorrCZT, /root/reference/pybinds/ippGroupXcorrCZT/
GroupXcorrCZT.cpp:215-216; strided in the Python threaded variant,
xcorrRoutines.py:1114-1135). Shifts are embarrassingly parallel, so here the
shift axis is sharded over the mesh with shard_map: rx and the (host-numpy,
program-constant) plan state are replicated, each device runs the same
batched gather->CZT/FFT->combine pipeline on its contiguous shift block, and
the (shifts, k) CAF comes back sharded over shifts (or reduced to one scalar
peak triple with only scalars crossing devices)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P


@functools.lru_cache(maxsize=64)
def _shard_shifts_fn(plan, mesh, axis, bs, step):
    # cached per (plan, mesh, geometry) — a fresh closure per call would
    # recompile the shard_map program every invocation
    def local(r, s):
        out = plan.xcorr(r, s, batch_size=bs, step=step)
        return out[0] if isinstance(out, tuple) else out

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                                 out_specs=P(axis), check_vma=False))


def _shard_shifts_call(plan, rx, shifts, mesh, axis, batch_size):
    """Common shard_map wrapper over a plan's jitted (rx, shifts) closure.
    The shifts' uniform stride is detected HOST-side (inside shard_map they
    are tracers) and passed through so each device's contiguous block takes
    the fast gather / fused-kernel tiers."""
    from pydsproutines_tpu.ops.xcorr import _uniform_step
    step = _uniform_step(shifts)
    shifts = jnp.asarray(shifts)
    ndev = mesh.shape[axis]
    nper = shifts.shape[0] // ndev
    if nper * ndev != shifts.shape[0]:
        raise ValueError("len(shifts) must divide evenly over the mesh axis")
    bs = int(min(batch_size, nper))
    return _shard_shifts_fn(plan, mesh, axis, bs, step)(rx, shifts)


def sharded_group_xcorr_czt(plan, rx: jnp.ndarray, shifts,
                            mesh: jax.sharding.Mesh, axis: str = "dsp",
                            batch_size: int = 32):
    """GroupXcorrCZT.xcorr with the shift axis sharded over ``mesh[axis]``.

    ``plan`` is an ops.groupxcorr.GroupXcorrCZT instance. Returns
    (caf (shifts, k), czt_freq) matching the single-device xcorr exactly."""
    return _shard_shifts_call(plan, rx, shifts, mesh, axis,
                              batch_size), plan.czt_freq


def sharded_group_xcorr_fft(plan, rx: jnp.ndarray, shifts,
                            mesh: jax.sharding.Mesh, axis: str = "dsp",
                            batch_size: int = 32):
    """GroupXcorrFFT.xcorr with the shift axis sharded over ``mesh[axis]``."""
    return _shard_shifts_call(plan, rx, shifts, mesh, axis, batch_size)


@functools.lru_cache(maxsize=64)
def _group_peak_fn(plan, mesh, axis, bs, step):
    def local(r, s):
        out = plan.xcorr(r, s, batch_size=bs, step=step)
        caf = out[0] if isinstance(out, tuple) else out
        flat = caf.reshape(-1)
        i = jnp.argmax(flat)
        si, fi = i // caf.shape[-1], i % caf.shape[-1]
        peaks = jax.lax.all_gather(flat[i], axis)
        sbest = jax.lax.all_gather(s[si], axis)
        fbest = jax.lax.all_gather(fi.astype(jnp.int32), axis)
        j = jnp.argmax(peaks)
        return peaks[j], sbest[j], fbest[j]

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                                 out_specs=(P(), P(), P()), check_vma=False))


def sharded_group_xcorr_peak(plan, rx: jnp.ndarray, shifts,
                             mesh: jax.sharding.Mesh, axis: str = "dsp",
                             batch_size: int = 32):
    """Global (peak QF^2, best shift, best freq bin) of a GroupXcorrCZT/FFT
    scan with only per-device scalars crossing devices — the multi-device form
    of the reference's threaded argmax-after-join."""
    shifts = jnp.asarray(shifts)
    ndev = mesh.shape[axis]
    nper = shifts.shape[0] // ndev
    if nper * ndev != shifts.shape[0]:
        raise ValueError("len(shifts) must divide evenly over the mesh axis")
    bs = int(min(batch_size, nper))
    from pydsproutines_tpu.ops.xcorr import _uniform_step
    step = _uniform_step(shifts)
    return _group_peak_fn(plan, mesh, axis, bs, step)(rx, shifts)
