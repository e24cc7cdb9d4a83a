"""PyTorch/CUDA port of the analytical-diffusion system (``repro``).

The module layout mirrors ``repro`` so each counterpart is easy to find.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper in
``repro_torch.kernels.ops`` uses its plain PyTorch version, on CUDA
tensors it launches the hand-written Hopper kernel or raises.
"""
