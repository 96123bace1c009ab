"""disco_tpu_torch — the graph-construction (buildG) slice of disco_tpu on
PyTorch and CUDA.

The package mirrors ``disco_tpu``'s module names.  The host modules (ingest,
QC, the fingerprint table, the replays) are numpy copies of their
counterparts, kept exact by the parity tests in ``tests/test_torch_*.py``;
the C++ host sources are compiled by path from ``disco_tpu/native``.  The
device half of buildG (window codes, table lookup, candidate compaction,
the dual window check, hit compaction) runs on torch tensors, and its two
checks are CUDA C++ kernels for sm_90a (``csrc/dual_compare.cu``).

Nothing here imports jax: packed words are int32 tensors carrying the
uint32 bits, and keys are int64 with the sign bit flipped.
"""
__version__ = "0.1.0"
