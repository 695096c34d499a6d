"""Analysis of the port's steps: ``counting`` (dot FLOPs and bytes, the
kernels' work and the collectives of a step, on any device) and
``roofline`` (the three-term H100 roofline of a dry-run record)."""
