"""The Scan2CAD CLI rehearsal: synthetic box-world scenes, their on-disk
split, the rehearsal trainer and the detector probe."""
