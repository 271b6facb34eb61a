"""Distribution layer: named meshes, shift-sharded CAF search, time-sharded
streaming filters/channelizer with halo exchange.

This layer is the genuinely new part relative to the reference (SURVEY.md
§2.6): the reference's parallelism is CPU thread striping and single-GPU batch
tiling; here the same embarrassing parallelism over shifts/channels/time
blocks is expressed as jax.sharding + shard_map over a device Mesh, with
collectives (ppermute halo exchange, psum/pmax reductions) instead of threads.
"""

from pydsproutines_tpu.parallel.mesh import make_mesh, default_mesh
from pydsproutines_tpu.parallel.xcorr import sharded_fast_xcorr, sharded_caf_peak
from pydsproutines_tpu.parallel.filters import sharded_lfilter
from pydsproutines_tpu.parallel.wola import sharded_wola, sharded_multichannel_wola
from pydsproutines_tpu.parallel.groupxcorr import (
    sharded_group_xcorr_czt, sharded_group_xcorr_fft,
    sharded_group_xcorr_peak)
from pydsproutines_tpu.parallel import multihost

__all__ = [
    "make_mesh",
    "default_mesh",
    "sharded_fast_xcorr",
    "sharded_caf_peak",
    "sharded_lfilter",
    "sharded_wola",
    "sharded_multichannel_wola",
    "sharded_group_xcorr_czt",
    "sharded_group_xcorr_fft",
    "sharded_group_xcorr_peak",
    "multihost",
]
