"""Compute kernels and their plain PyTorch versions: the K1 dirs16+runs
fill and K3 score fill (``rowcb``), the K2 run-length walk and its host
replays (``device_walk``), and the build of the CUDA sources
(``_build``). Submodules are imported where they are used."""
