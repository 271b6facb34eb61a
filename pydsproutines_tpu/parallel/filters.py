"""Time-sharded FIR filtering with halo exchange.

The distributed form of the streaming delay-line filter
(pydsproutines_tpu.ops.filters.stream_lfilter_step, mirroring the reference
CupyFilter): a long capture is sharded into contiguous time blocks across the
mesh; each device receives the last len(taps) samples of its left neighbour's
block via ``ppermute`` (the overlap-save halo), filters locally, and
the concatenation of local outputs equals the single-device filter output
exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pydsproutines_tpu.ops.filters import stream_lfilter_step


def sharded_lfilter(taps: jnp.ndarray, x: jnp.ndarray,
                    mesh: jax.sharding.Mesh, axis: str = "dsp") -> jnp.ndarray:
    """FIR-filter ``x`` (length divisible by the mesh axis size) with the time
    axis sharded over ``mesh[axis]``. Output length == len(x), identical to
    ops.filters.lfilter_fir."""
    ndev = mesh.shape[axis]
    if x.shape[-1] % ndev != 0:
        raise ValueError("len(x) must divide evenly over the mesh axis")
    t = taps.shape[-1]

    def local(tp, xl):
        # halo: my last t samples -> right neighbour (device i -> i+1)
        i = jax.lax.axis_index(axis)
        nd = jax.lax.axis_size(axis)
        tail = xl[-t:]
        perm = [(d, d + 1) for d in range(nd - 1)]
        halo = jax.lax.ppermute(tail, axis, perm)  # device 0 gets zeros
        halo = jnp.where(i == 0, jnp.zeros_like(halo), halo)
        y, _ = stream_lfilter_step(tp, xl, halo)
        return y

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                               out_specs=P(axis), check_vma=False))
    return fn(taps.astype(x.dtype), x)
