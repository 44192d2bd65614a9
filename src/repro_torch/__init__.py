"""PyTorch + CUDA port of the GSNR/VRGD system (reference: the ``repro``
JAX package beside it).  Imports neither JAX nor ``repro``; kernels are
built from ``kernels/csrc`` on first use on a CUDA device."""
