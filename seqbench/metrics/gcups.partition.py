"""``gcups`` in the cells of whole pairs through the partition, under a
bound of their own: the partition is paced by the host, whose speed
wanders from run to run far more than in a batch (``PERF.md`` section 2)."""

import manifest


def read(r):
    return manifest.reader("gcups")(r)
