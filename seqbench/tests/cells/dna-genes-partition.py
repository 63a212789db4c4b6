"""``dna-genes-partition`` at the sizes of the CPU tests: (scale,
max_items) of a pass."""

# a pass small enough for the plain twins: 3 pairs of 27-61 x 160-171 nt
SMALL = (0.002, 3)
# sizes at which bfloat16 can no longer hold the scores (over 256)
CONTROL = (0.05, 4)
