"""Streaming FASTA reader.

Mirrors the reference's line-buffered reader (handle_one_file.c:201-269):
IDs are the header text after '>' up to CR/LF (truncated to BLK-2 chars),
sequence lines are concatenated, any character outside ACGTacgt (incl. N)
is fatal, and reads longer than max_input_length are fatal.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from mtr.utils.encoding import encode_bases

_MAX_ID = 4094  # BLK - 2 (handle_one_file.c:215)


@dataclasses.dataclass
class Read:
    read_id: str
    codes: np.ndarray  # int32 codes 0..3

    @property
    def length(self) -> int:
        return len(self.codes)


class FatalInputError(ValueError):
    """Input violates a reference hard limit (handle_one_file.c:244-248):
    diagnostic to stderr + EXIT_FAILURE at the CLI."""


def iter_fasta(path: str, max_input_length: int = 1_000_000) -> Iterator[Read]:
    read_id: str | None = None
    chunks: list[bytes] = []

    def finish() -> Read:
        seq = b"".join(chunks)
        if len(seq) >= max_input_length:
            raise FatalInputError(
                f"read {read_id!r} has length {len(seq)} >= limit {max_input_length}"
            )
        return Read(read_id=read_id, codes=encode_bases(seq))

    with open(path, "rb") as fp:
        for raw in fp:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if read_id is not None:
                    yield finish()
                read_id = line[1:].decode("ascii", "replace")[:_MAX_ID]
                chunks = []
            elif line:
                chunks.append(line)
        if read_id is not None:
            yield finish()
