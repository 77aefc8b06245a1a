"""genmap_tpu_torch — the PyTorch/CUDA port of genmap_tpu.

(k,e)-mappability on an NVIDIA GPU: the same index format, the same search
(optimal search schemes over an FMD-index of both strands, lockstep
frontiers of k-mer blocks, capacity-tier escalation) and byte-identical
outputs, with the hot device functions written as CUDA kernels
(`genmap_tpu_torch/csrc`, bound in `genmap_tpu_torch/kernels.py`).

This package imports torch and numpy only; it shares no module with the JAX
package `genmap_tpu`, which stays the reference it is tested against.
"""

__version__ = "0.1.0"
