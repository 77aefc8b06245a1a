"""FASTA / BED readers and byte-exact output writers."""
