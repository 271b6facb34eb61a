"""pydsproutines_tpu — a software-radio DSP framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
``icyveins7/pydsproutines`` toolkit (see SURVEY.md): synthetic signal
generation, FFT/CZT spectral transforms, FIR/upfirdn filtering, WOLA
channelization, burst detection, cross-correlation / CAF search, PSK/CPFSK/
Viterbi demodulation, and downstream localization/CRB estimation.

Design stance (SURVEY.md §7): one algorithm, one implementation — jax-traced
functions that run on CPU (parity tier) and GPU (compiled), replacing the
reference's NumPy/IPP/CUDA three-tier duplication; scaling happens via named
meshes + shard_map, not threads.
"""

__version__ = "0.1.0"

from pydsproutines_tpu import utils  # noqa: F401
