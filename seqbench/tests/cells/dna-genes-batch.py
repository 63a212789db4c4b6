"""``dna-genes-batch`` at the sizes of the CPU tests: (scale, max_items)
of a pass."""

# a pass small enough for the plain twins
SMALL = (0.005, 6)
# sizes at which bfloat16 can no longer hold the scores (over 256)
CONTROL = (0.1, 4)
