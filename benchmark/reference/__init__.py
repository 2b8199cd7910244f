"""The plain reference: NumPy and plain PyTorch, importing nothing of the
program. Frozen copies of the program's data rules (the hash to slots,
the batch order, the table's V initialisation) sit beside a float64
trainer that follows the program's first steps from the same seed."""
