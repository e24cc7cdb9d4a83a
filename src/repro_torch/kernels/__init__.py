"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the device-dispatching public layer (``ops``)."""
