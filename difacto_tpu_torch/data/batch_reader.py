"""Minibatches with a shuffle buffer and negative downsampling
(counterpart of difacto_tpu/data/batch_reader.py; the reference's
BatchReader, src/reader/batch_reader.{h,cc}).

- fixed ``batch_size`` batches over a :class:`Reader` part; the last one
  may be short;
- ``shuffle_buf_size`` > 0 reads buffers of that many rows and emits each
  as a random permutation (``np.random.RandomState(seed)``);
- ``neg_sampling`` < 1 drops each negative row with probability
  ``neg_sampling`` (the reference keeps a negative iff
  ``p <= 1 - neg_sampling``, batch_reader.cc:58-64);
- all-ones value arrays drop to the binary representation.

Numpy only, and the same draws in the same order as the JAX package's
reader, so both packages cut the same batches from the same seed.
"""

from __future__ import annotations

from typing import Iterator, Union

import numpy as np

from .reader import Reader
from .rowblock import RowBlock, RowBlockBuilder


class BatchReader:
    def __init__(self, uri: str, data_format: str = "libsvm",
                 part_idx: int = 0, num_parts: int = 1,
                 batch_size: int = 100, shuffle_buf_size: int = 0,
                 neg_sampling: float = 1.0, seed: int = 0,
                 chunk_bytes: int = 1 << 26):
        self._src: Union[BatchReader, Reader]
        if shuffle_buf_size:
            if shuffle_buf_size < batch_size:
                raise ValueError("shuffle buffer must be >= batch_size")
            # a BatchReader of the buffer size feeds the shuffler
            # (batch_reader.cc:18-22)
            self._src = BatchReader(uri, data_format, part_idx, num_parts,
                                    batch_size=shuffle_buf_size,
                                    chunk_bytes=chunk_bytes)
        else:
            self._src = Reader(uri, data_format, part_idx, num_parts,
                               chunk_bytes)
        self.batch_size = batch_size
        self.shuffle_buf_size = shuffle_buf_size
        self.neg_sampling = neg_sampling
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[RowBlock]:
        builder = RowBlockBuilder()
        for blk in self._src:
            rows = np.arange(blk.size)
            if self.shuffle_buf_size:
                self._rng.shuffle(rows)
            if self.neg_sampling < 1.0:
                keep = (blk.label[rows] > 0) | (
                    self._rng.random_sample(len(rows))
                    <= 1.0 - self.neg_sampling)
                rows = rows[keep]
            start = 0
            while start < len(rows):
                take = min(self.batch_size - builder.num_rows,
                           len(rows) - start)
                builder.push_rows(blk, rows[start:start + take])
                start += take
                if builder.num_rows >= self.batch_size:
                    yield builder.build().drop_binary_values()
                    builder.clear()
        if builder.num_rows:
            yield builder.build().drop_binary_values()
