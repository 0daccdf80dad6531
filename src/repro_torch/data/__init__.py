from .pipeline import lsq_dataset, lsq_rows

__all__ = ["lsq_dataset", "lsq_rows"]
