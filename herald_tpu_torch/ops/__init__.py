from herald_tpu_torch.ops.embedding import (dedup_ids, embedding_lookup,
                                            scatter_add_rows,
                                            segment_sum_grads)
