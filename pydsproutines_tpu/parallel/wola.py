"""Time-sharded WOLA channelizer with halo exchange.

The distributed form of the streaming Channeliser: a long capture is sharded
into contiguous time blocks; each device pulls a filter-length halo from its
left neighbour (``ppermute``), runs the local WOLA fold+IFFT, and
drops the warm-up rows — the row-concatenated output equals the single-device
wola() of the whole capture exactly (including the N == 2*Dec phase-flip
parity, kept globally consistent via wola's row_offset).

This re-expresses the reference's channel/time-striped threading
(multiChannelWola.c:79, cpuWolaDll.c:68) as mesh sharding (SURVEY.md §2.6).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pydsproutines_tpu.ops.wola import wola


@functools.lru_cache(maxsize=64)
def _sharded_wola_fn(mesh, axis, dec, n, L, jump, rows_per_dev):
    def local(tp, xl):
        i = jax.lax.axis_index(axis)
        nd = jax.lax.axis_size(axis)
        tail = xl[-L:]
        perm = [(d, d + 1) for d in range(nd - 1)]
        halo = jax.lax.ppermute(tail, axis, perm)
        halo = jnp.where(i == 0, jnp.zeros_like(halo), halo)
        y = jnp.concatenate([halo, xl])
        # local row r of wola(y) <-> global row i*rows_per_dev - jump + r
        row_offset = i * rows_per_dev - jump
        ch = wola(tp, y, dec, n, row_offset=row_offset)
        return ch[jump:, :]

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                                 out_specs=P(axis), check_vma=False))


@functools.lru_cache(maxsize=64)
def _sharded_mc_wola_fn(mesh, axis, dec, n):
    def local(tp, xl):
        return jax.vmap(lambda row: wola(tp, row, dec, n))(xl)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                                 out_specs=P(axis), check_vma=False))


def sharded_wola(f_tap: jnp.ndarray, x: jnp.ndarray, dec: int, n: int,
                 mesh: jax.sharding.Mesh, axis: str = "dsp") -> jnp.ndarray:
    """WOLA channelize with the time axis sharded over ``mesh[axis]``.

    Requires len(x) divisible by (mesh axis size * dec) and the per-device
    block length >= len(f_tap). Returns (len(x)//dec, n), equal to
    ops.wola.wola(f_tap, x, dec, n).
    """
    ndev = mesh.shape[axis]
    total = x.shape[-1]
    if total % (ndev * dec) != 0:
        raise ValueError("len(x) must divide evenly over mesh axis * dec")
    block = total // ndev
    L = f_tap.shape[-1]
    if block < L:
        raise ValueError("per-device block must be >= filter length")
    jump = L // dec
    rows_per_dev = block // dec
    fn = _sharded_wola_fn(mesh, axis, int(dec), int(n), int(L), int(jump),
                          int(rows_per_dev))
    return fn(f_tap, x)


def sharded_multichannel_wola(f_tap: jnp.ndarray, x: jnp.ndarray, dec: int,
                              n: int, mesh: jax.sharding.Mesh,
                              axis: str = "dsp") -> jnp.ndarray:
    """Channelize a (channels, len) stack of independent captures with the
    CHANNEL axis sharded over ``mesh[axis]`` — the mesh form of the
    reference's channel-striped threading (one thread per outer channel,
    /root/reference/multiChannelWola.c:79). No halo: channels are
    independent, so there is zero inter-device traffic.

    Returns (channels, len//dec, n), equal to vmapping ops.wola.wola over
    rows. Combine with time sharding by using a 2-D mesh: channels on one
    axis (this function), time blocks on the other (sharded_wola)."""
    ndev = mesh.shape[axis]
    if x.ndim != 2:
        raise ValueError("x must be (channels, len)")
    if x.shape[0] % ndev != 0:
        raise ValueError("channel count must divide evenly over the mesh axis")
    fn = _sharded_mc_wola_fn(mesh, axis, int(dec), int(n))
    return fn(f_tap, x)
