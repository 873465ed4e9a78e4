"""PyTorch port of the ST-LF reproduction, for NVIDIA Hopper (H100).

Mirrors the JAX package ``repro`` module for module (``data``, ``core``,
``nn``, ``fl``, ``kernels``) and imports nothing of it.  The numpy-only
modules are copies; the CNN, local training, Algorithm-1 divergence
estimation, the SCA solver's inner loop and the transfer run in torch, and
the two ST-LF Pallas kernels (``alpha_combine``, ``disagreement``) are CUDA
C++ kernels for ``sm_90a`` under ``kernels/``.

Entry points (``prepare_round``, ``run_stlf``, ``evaluate_assignment``,
``python -m repro_torch.quickstart``) run on ``cuda`` unless the caller
passes ``device="cpu"``; see ``repro_torch.device``.
"""
