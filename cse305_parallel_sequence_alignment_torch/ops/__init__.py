"""Compute kernels and their plain PyTorch versions: the K1 dirs16+runs
fill and K3 score fill (``rowcb``), the K2 run-length walk and its host
replays (``device_walk``), the K6 long fill and its last rows
(``longrow``), the K7 single-job last row (``longstair``), and the build
of the native sources (``_build``). Submodules are imported where they
are used."""
