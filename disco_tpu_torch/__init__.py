"""disco_tpu_torch — disco_tpu on PyTorch and CUDA: graph construction
(buildG, also distributed over processes), graph simplification
(fullsimplify, parsimplify), BBTools preprocessing and the ``assemble``,
``preprocess`` and ``stats`` commands.

The package mirrors ``disco_tpu``'s module names.  The host modules (ingest,
QC, the fingerprint table, the replays, all of ``simplify``) are numpy
copies of their counterparts, kept exact by the parity tests in
``tests/test_torch_*.py``; the C++ host sources are copies of the JAX
package's, in ``native/src``, but for the traversal replay the port runs,
its own ``native/port/replay.cpp``, held to the copy's output.  The
device half of buildG (window codes, table lookup, candidate compaction,
the dual window check, hit compaction) runs on torch tensors, and its two
checks are CUDA C++ kernels for sm_90a (``csrc/dual_compare.cu``).

Nothing here imports jax: packed words are int32 tensors carrying the
uint32 bits, and keys are int64 with the sign bit flipped.
"""
__version__ = "0.1.0"
