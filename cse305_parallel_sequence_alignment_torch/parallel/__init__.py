"""Long-pair decomposition: the balanced partition (``partition``)."""
