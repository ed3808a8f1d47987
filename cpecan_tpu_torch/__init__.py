"""cpecan_tpu_torch — the PyTorch/CUDA port of cpecan_tpu.

The package mirrors cpecan_tpu's module paths (``cpecan_tpu_torch.ops.
fb_wavefront`` is the counterpart of ``cpecan_tpu.ops.fb_wavefront``) and
runs posterior realignment and Baum-Welch EM on an NVIDIA Hopper card
through three hand-written CUDA kernels (``csrc/wavefront.cu``). It
stands alone: the host-side modules it needs (config, HMM files,
cigar/fasta I/O, banding, pair decoding, the poset filter and the C++
host helpers in ``csrc/host/``) are its own copies, and it imports
nothing of cpecan_tpu.

On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. This package never imports
jax.
"""

__version__ = "0.2.0"
