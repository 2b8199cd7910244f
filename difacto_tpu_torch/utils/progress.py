"""Training progress records (counterpart of difacto_tpu/utils/progress.py;
the reference's sgd::Progress, src/sgd/sgd_utils.h:52-110).

Raw sums of {nrows, loss, auc, penalty, nnz_w} merged by elementwise add;
the printer divides by nrows. :class:`ReportProg` prints the throttled
live progress row (Report_prog::PrintStr, sgd_utils.h:97-110) in the JAX
package's format.
"""

from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass
class Progress:
    nrows: float = 0.0
    loss: float = 0.0
    auc: float = 0.0
    penalty: float = 0.0
    nnz_w: float = 0.0

    def merge(self, other: "Progress") -> "Progress":
        for f in fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0.0)

    def text(self) -> str:
        n = max(self.nrows, 1.0)
        return (f"Rows = {self.nrows:g}, loss = {self.loss / n:.6f}, "
                f"AUC = {self.auc / n:.6f}")


class ReportProg:
    """Accumulating live progress printer."""

    def __init__(self) -> None:
        self.prog = Progress()
        self.total_rows = 0.0
        self.total_nnz = 0.0

    def print_str(self) -> str:
        self.total_rows += self.prog.nrows
        self.total_nnz += self.prog.nnz_w
        n = max(self.prog.nrows, 1.0)
        s = (f"{self.total_rows:9.4g}  {self.prog.nrows:7.2g} | "
             f"{self.total_nnz:9.4g} | {self.prog.loss / n:6.4f}  "
             f"{self.prog.auc / n:7.5f} ")
        self.prog.reset()
        return s
