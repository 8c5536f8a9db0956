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
  quant_split   - ``quant_split`` (csrc/quant_split.cu): a migration's
                  re-tiering of every same-shaped FFN matrix in one
                  launch, each fp32 weight read once and each tier written
                  once as int8 (per-column scales) or bf16; the serve
                  engine's ``_retier``. It replaces no TPU kernel (XLA
                  fuses the JAX package's ``split_weight``).
  rglru_scan    - ``rglru_scan`` / ``rglru_scan_bwd`` (csrc/rglru_scan.cu):
                  the RG-LRU's linear recurrence over a sequence and its
                  backward, one thread per (batch row, channel).
  mlstm_scan    - ``mlstm_scan`` / ``mlstm_scan_bwd`` (csrc/mlstm_scan.cu):
                  xLSTM's mLSTM recurrence, chunkwise, the (hd x hd)
                  state kept on chip per head, and its backward.
  slstm_scan    - ``slstm_scan`` / ``slstm_scan_bwd`` (csrc/slstm_scan.cu):
                  xLSTM's sLSTM recurrence as a chunked scan over time,
                  and its backward, the same scan run backwards.
  decode_attn   - ``decode_attn`` (csrc/decode_attn.cu): one decode
                  token of grouped-query attention a layer in one launch
                  (RoPE, the KV-ring write, fp32 scores and softmax, the
                  value product); ``models.attention.attention_decode``
                  on plain CUDA bf16 caches. It replaces no TPU kernel
                  (XLA fuses the JAX package's attention_decode).
  build         - nvcc -> shared library -> ctypes loader.

The scans are ``torch.library`` custom ops (fake versions, a DTensor
rule, FLOP counts; each forward's autograd is its backward op) and stand
in for the JAX package's ``lax.associative_scan`` / ``lax.scan`` in
``repro/models/recurrent.py``, which has no Pallas kernel for them.

A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
"""
