"""The benchmark of the PyTorch and CUDA port (``repro_torch``): GoldDiff
image serving through ``ServeEngine``; ``run.py`` runs one cell."""
