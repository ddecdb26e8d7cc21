"""Data parallelism over ranks (one process a device) — the port's
counterpart of `sgam_neurips22_tpu/parallel/`: `distributed` (process
group, collectives, launch) and `mesh` (the data axis of one rank's view)."""
