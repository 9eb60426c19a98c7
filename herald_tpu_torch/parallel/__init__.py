"""Distributed training over torch.distributed (port of
`herald_tpu/parallel/`): `exchange` routes ids and rows between the ranks
that own the table's rows, `comm` holds the process group, its subgroups
and the collectives, `tp` the tensor-parallel tower's helpers,
`pipeline` GPipe, 1F1B and HetPipe over a pp group, and `autoshard` the
(dp, mp) layout search."""
