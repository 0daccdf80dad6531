from .paper_native import (PAPER_LASSO, PAPER_LOGISTIC, PAPER_MF,
                           PAPER_PROBLEMS, PAPER_RIDGE,
                           QuadraticProblemConfig)

__all__ = ["PAPER_RIDGE", "PAPER_MF", "PAPER_LOGISTIC", "PAPER_LASSO",
           "PAPER_PROBLEMS", "QuadraticProblemConfig"]
