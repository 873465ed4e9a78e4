"""Hand-written CUDA kernels for Hopper (``sm_90a``), one folder each:

  <name>/csrc/*.cu  — the kernel and a plain C entry point
  <name>/ops.py     — wrapper (launch counter, checks), plain PyTorch
                      version, ctypes binding

alpha_combine : weighted source->target parameter mixing (ST-LF transfer)
disagreement  : pairwise prediction-disagreement matrix (eq. (4) for
                every hypothesis pair)
flash_attention : causal / sliding-window / bidirectional attention with
                the online softmax (the LM's prefill)
ssm_scan      : chunked gated linear attention, the rwkv / mamba scan
                (the rwkv model's prefill)

``_build.py`` compiles the sources with ``nvcc`` at first use.  A wrapper
given a CPU tensor computes its plain version; given a CUDA tensor it
launches the kernel or raises.
"""
