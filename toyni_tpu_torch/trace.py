"""Execution-trace frontend: columns of equal power-of-two height, held on
the host as numpy uint64 and interpolated by an INTT on the trace domain."""

from __future__ import annotations

import numpy as np
import torch

from .domain import Domain


class ExecutionTrace:
    """Columns of equal power-of-two height."""

    def __init__(self):
        self.columns: list[np.ndarray] = []

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def insert_column(self, column) -> None:
        """Append a column of per-row values."""
        col = np.asarray(column, np.uint64)
        if self.columns:
            assert len(col) == self.num_rows, "Column length mismatch"
        self.columns.append(col)

    def interpolate_column(self, domain: Domain, column_idx: int,
                           device="cpu") -> torch.Tensor:
        """Coefficients of the unique interpolant of the column over
        `domain`, as an int64 tensor on `device`."""
        assert domain.size == self.num_rows, "Domain length must match trace height"
        assert domain.shift == 1, "trace domain is the standard domain"
        col = torch.from_numpy(self.columns[column_idx].astype(np.int64))
        return domain.ifft(col.to(device))
