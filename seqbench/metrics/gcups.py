"""Valid DP cells (la x lb) of every pair completed, over the window, in
billions a second."""


def read(r):
    return r.passes * r.passage.cells(r.swap) / r.elapsed_s / 1e9
