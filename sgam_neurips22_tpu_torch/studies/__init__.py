"""Measurement studies run on the card: each reproduces numbers in PERF.md
for designs that were measured and rejected. Nothing in the port imports
them."""
