"""Hand-written CUDA kernels of the port, each beside its plain version.

  knapsack_dp   - ``dp_stages`` (csrc/dp_stages.cu): Algorithm-1 stage
                  tables of every (variant, cluster) plus the
                  consulted-row gather; the ``knapsack_dp`` op.
  lut_pipeline  - ``minplus_combine`` (csrc/minplus_combine.cu): the
                  Algorithm-2 min-plus fold, final combine and split
                  backtrace; the fused ``lut_build`` op.
  pim_mac       - ``pim_matmul`` (csrc/pim_mac.cu): W8A8 matmul on the
                  int8 tensor cores with an exact int32 accumulator and
                  the dequantizing epilogue; the int8 tiers of
                  ``models.hetero_linear.tiered_matmul``.
  build         - nvcc -> shared library -> ctypes loader.

A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
"""
