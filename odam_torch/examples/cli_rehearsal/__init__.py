"""The Scan2CAD CLI rehearsal: synthetic box-world scenes, their on-disk
split, the rehearsal trainer and the detector probe, and the studies run
on them (ablation matrices, operating-point sweeps, recall diagnosis, miss
audit, bootstrap scoring)."""
