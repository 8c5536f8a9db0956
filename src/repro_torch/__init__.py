"""``repro_torch`` - the HH-PIM placement and serving runtime on PyTorch
and CUDA.

The port of the JAX package ``repro`` (which stays the reference): the
same module layout and names, plain functions on tensors with an
explicit ``device``, and hand-written CUDA kernels for Hopper in place
of the Pallas TPU kernels. Construct the stack through
:mod:`repro_torch.api`.
"""
