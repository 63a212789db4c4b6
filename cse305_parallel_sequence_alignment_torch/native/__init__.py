"""Host replay and render library (``walker``), built at first use."""
