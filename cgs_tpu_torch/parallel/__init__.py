"""Data parallelism over cards with torch.distributed (port of
`cgs_tpu/parallel/`): `multihost` starts and joins the ranks, `mesh`
holds the layout and the collectives."""
