"""Support utilities: run configuration and FASTA input."""
