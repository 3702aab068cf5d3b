"""FASTA/FASTQ read streaming with the reference producer semantics
(reference: src/kaiju.cpp:259-405): per-file format auto-detection by the
first character, read-name truncation at the first of " /\\t\\r", multi-line
FASTA accumulation, non-alphabetic character stripping, paired-file name
checks, transparent gzip."""

from __future__ import annotations

import gzip
import io
import re
import sys
from typing import Iterator, Optional

_NAME_CUT = re.compile(r"[ /\t\r]")
_NON_ALPHA = re.compile(r"[^A-Za-z]+")


class FastxError(RuntimeError):
    pass


def _open_text(path: str):
    fh = open(path, "rb")
    magic = fh.read(2)
    fh.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=fh))
    return io.TextIOWrapper(fh)


def _trim_name(line: str) -> str:
    """Strip the marker char and cut at ' /\\t\\r'
    (reference: kaiju.cpp:302-307)."""
    body = line[1:]
    m = _NAME_CUT.search(body)
    return body[: m.start()] if m else body


def _strip_seq(seq: str) -> str:
    """Remove non-alphabetic characters (reference: util.cpp:25-32)."""
    return _NON_ALPHA.sub("", seq)


class _Reader:
    """Single-file record reader (format detected on first record)."""

    def __init__(self, path: str):
        self.path = path
        self.fh = _open_text(path)
        self.is_fastq: Optional[bool] = None
        self._pending: Optional[str] = None  # lookahead line

    def _next_line(self) -> Optional[str]:
        if self._pending is not None:
            line, self._pending = self._pending, None
            return line
        line = self.fh.readline()
        return line if line else None

    def next_record(self) -> Optional[tuple[str, str]]:
        # skip empty lines (reference: kaiju.cpp:289, 334-341)
        while True:
            line = self._next_line()
            if line is None:
                return None
            line = line.rstrip("\n")
            if line:
                break
        if self.is_fastq is None:
            if line[0] == "@":
                self.is_fastq = True
            elif line[0] == ">":
                self.is_fastq = False
            else:
                raise FastxError(
                    f"Auto-detection of file type for file {self.path} failed."
                )
        name = _trim_name(line)
        if self.is_fastq:
            seq = (self.fh.readline() or "").rstrip("\n")
            self.fh.readline()  # + line
            self.fh.readline()  # quality
            return name, _strip_seq(seq)
        chunks = []
        while True:
            line = self.fh.readline()
            if not line:
                break
            if line.startswith(">"):
                self._pending = line
                break
            chunks.append(line.rstrip("\n"))
        return name, _strip_seq("".join(chunks))

    def has_more_data(self) -> bool:
        line = self.fh.readline()
        return bool(line and line.rstrip("\n"))


def read_reads(
    path1: str, path2: Optional[str] = None
) -> Iterator[tuple[str, str, Optional[str]]]:
    """Yield (name, seq1, seq2-or-None) with reference pairing semantics."""
    r1 = _Reader(path1)
    r2 = _Reader(path2) if path2 else None
    while True:
        rec1 = r1.next_record()
        if rec1 is None:
            break
        name, seq1 = rec1
        if r2 is None:
            yield name, seq1, None
            continue
        rec2 = r2.next_record()
        if rec2 is None:
            raise FastxError(
                f"File {path1} contains more reads then file {path2}"
            )
        name2, seq2 = rec2
        if name != name2:
            raise FastxError(
                "Read names are not identical between the two input files. "
                "Probably reads are not in the same order in both files."
            )
        yield name, seq1, seq2
    if r2 is not None and r2.has_more_data():
        print(
            f"Warning: File {path2} has more reads then file {path1}",
            file=sys.stderr,
        )


def batched(iterator, batch_size: int):
    batch = []
    for item in iterator:
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def prefetch_batches(iterator, batch_size: int, depth: int = 4):
    """Producer-thread batching: parse runs in a background thread with a
    bounded queue, overlapping file IO + parsing with classification —
    the reference's producer thread + 500-slot ProducerConsumerQueue
    (reference: kaiju.cpp:250-257,288-394).  The parser fills while the
    consumer blocks on device fetches (which release the GIL)."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    cancelled = threading.Event()

    def produce():
        try:
            for batch in batched(iterator, batch_size):
                while not cancelled.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # surface parse errors to the consumer
            if not cancelled.is_set():
                q.put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # consumer abandoned the generator (break / downstream exception)
        # or finished: unblock and reap the producer either way
        cancelled.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join()
