"""cpecan_tpu_torch — the PyTorch/CUDA port of cpecan_tpu.

The package mirrors cpecan_tpu's module paths (``cpecan_tpu_torch.ops.
fb_wavefront`` is the counterpart of ``cpecan_tpu.ops.fb_wavefront``) and
runs the posterior-realignment path on an NVIDIA Hopper card through two
hand-written CUDA kernels (``csrc/wavefront.cu``). Host-side modules that
import no jax (config, HMM files, cigar/fasta I/O, banding, pair decoding,
the poset filter) are reused from cpecan_tpu by import.

On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. This package never imports
jax.
"""

__version__ = "0.1.0"
