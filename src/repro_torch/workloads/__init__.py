"""Workload generators of this slice's path: the per-object size catalogue
for byte-capacity caches and the adversarial ``scan`` trace (copies of the
reference package's, so the port imports nothing of it)."""
