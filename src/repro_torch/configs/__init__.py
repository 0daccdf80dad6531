from .paper_native import PAPER_RIDGE, QuadraticProblemConfig

__all__ = ["PAPER_RIDGE", "QuadraticProblemConfig"]
