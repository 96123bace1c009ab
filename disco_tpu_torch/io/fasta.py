"""Streaming FASTA/FASTQ(.gz) record reader.

Record semantics match the reference parser so that file indices line up:
- FASTA: a '>' header line, then every line until the next '>' concatenated
  (newlines stripped) forms one record
  (reference: src/BuildGraph/src/Dataset.cpp:270-281).
- FASTQ: strict 4-line records (reference: src/BuildGraph/src/Dataset.cpp:282-293).
- Sequences are upper-cased (reference: src/BuildGraph/src/Dataset.cpp:303-304).
- File type is sniffed from the first character ('>' FASTA, '@' FASTQ)
  (reference: src/BuildGraph/src/Dataset.cpp:260-267).
"""
import gzip
from typing import Iterator


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_bytes(path: str) -> bytes:
    """Whole-file raw bytes, transparently gunzipped (native-scan input)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def scan_records(path: str):
    """Native record scan -> (seq_blob uint8, (n+1,) offsets).  Plain files
    use the streaming mmap scanner (no in-memory raw copy, exact-size
    blob); gzip falls back to the in-memory scan."""
    from .. import native
    if not path.endswith(".gz"):
        res = native.seq_scan_path(path)
        if res is not None:
            return res
    return native.seq_scan(read_bytes(path))


def read_records(path: str) -> Iterator[str]:
    """Yield upper-cased sequence strings, one per record, in file order."""
    with _open(path) as f:
        first = f.read(1)
        if first == ">":
            # FASTA: split on '>' like the reference's getline(myFile, text, '>')
            chunk = f.read()
            for rec in chunk.split(">"):
                if not rec:
                    continue
                nl = rec.find("\n")
                if nl < 0:
                    yield ""  # header with no sequence
                    continue
                yield rec[nl + 1:].replace("\n", "").upper()
        elif first == "@":
            # FASTQ
            f.readline()  # rest of header
            while True:
                seq = f.readline()
                if not seq:
                    break
                yield seq.strip().upper()
                f.readline()  # '+'
                f.readline()  # quals
                hdr = f.readline()
                if not hdr:
                    break
        elif first == "":
            return
        else:
            raise ValueError(f"Unknown input file format: {path}")
