from .pipeline import (CodedBatcher, GroupBatcher, TokenStream,
                       logreg_dataset, logreg_rows, lsq_dataset, lsq_rows,
                       mf_ratings_dataset, stream_worker_blocks)

__all__ = ["TokenStream", "CodedBatcher", "GroupBatcher", "lsq_dataset",
           "lsq_rows", "logreg_dataset", "logreg_rows", "mf_ratings_dataset",
           "stream_worker_blocks"]
