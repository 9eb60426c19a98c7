"""Row-sharded embedding exchange over torch.distributed (port of
`herald_tpu/parallel/`): `exchange` routes ids and rows between the ranks
that own the table's rows, `comm` holds the process group and the
collectives."""
