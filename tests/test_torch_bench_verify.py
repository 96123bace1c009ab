"""The slice as a whole: disco_tpu_torch.bench_verify against bench.py and
the JAX verify paths it times (tools/bench_verify_paths.py), on a small
tools/make_testdata.py set (20 kb, 25x, 250 bp reads, with substitution
errors so that some candidate windows mismatch).  The JAX kernels run
in interpret mode; the port's paths run their plain versions on the CPU.
Tolerance: exact — integer arrays and booleans."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from disco_tpu.io.readstore import ReadStore as RefReadStore
from disco_tpu.overlap import fused_kernel as jfk
from disco_tpu.overlap import verify as jv
from disco_tpu.overlap.locality import relabel_workload
from disco_tpu_torch import bench_verify as bv
from disco_tpu_torch.io.readstore import ReadStore
from test_torch_native import private_native  # noqa: F401

# the tests run in several worker processes at once: one intra-op thread
# each keeps torch from spinning against the other workers
torch.set_num_threads(1)

SLICE = 4096


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    fasta = tmp_path_factory.mktemp("bench_verify") / "small.fasta"
    subprocess.run(
        [sys.executable, str(bv.ROOT / "tools" / "make_testdata.py"),
         str(fasta), "--genome-len", "20000", "--coverage", "25",
         "--read-len", "250", "--insert", "600", "--seed", "7",
         "--error-rate", "0.002"],
        check=True, stdout=subprocess.DEVNULL)
    return bench.candidate_batch(str(fasta)), bv.candidate_batch(fasta)


def test_candidate_batch_and_spans_equal_bench(batches):
    (rstore, *want), (store, *got) = batches
    assert store.n_reads == rstore.n_reads and store.n_words == 16
    np.testing.assert_array_equal(store.packed, rstore.packed)
    np.testing.assert_array_equal(store.packed_rc, rstore.packed_rc)
    assert len(got[0]) > 4 * SLICE
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    r1, rows2 = got[0], got[1]
    for rows in (r1, rows2, r1[bv.centred_slice(len(r1), SLICE)]):
        assert bv.tile_spans(rows) == bench._tile_spans(rows)
    assert (got[4] > 0).any() and (got[4] == 0).any()


def _jax_path(path, store, r1, rows2, o1, o2, n):
    """bench.py's preparation and call of `path` with the JAX package, over
    the centred slice; returns (booleans, relabel permutation or None)."""
    pa = np.asarray(jv.make_packed_all(store.packed, store.packed_rc))
    perm = None
    if path == "fused_mxu3":
        pa, r1, rows2, perm, _, o1, o2, n = relabel_workload(
            store.n_reads, pa, r1, rows2, o1, o2, n)
    sl = bv.centred_slice(len(r1), SLICE)
    args = [x[sl] for x in (r1, rows2, o1, o2, n)]
    if path == "xla":
        return np.asarray(jv.verify_windows(
            pa, *args, n_words=store.n_words)), perm
    table, fn = {
        "pallas": (pa, jv.verify_windows_pallas),
        "fused": (pa, jfk.verify_windows_fused),
        "fused_t": (np.ascontiguousarray(pa.T), jfk.verify_windows_fused_t),
        "fused_mxu": (jfk.pack_lines(pa)[0], jfk.verify_windows_fused_mxu),
        "fused_mxu2": ((jfk.pack_lines(pa)[0], pa),
                       jfk.verify_windows_fused_mxu),
        "fused_mxu3": (jfk.pack_lines16(pa)[0],
                       jfk.verify_windows_fused_mxu_both16),
    }[path]
    return np.asarray(fn(table, *args, n_words=store.n_words,
                         interpret=True)), perm


@pytest.mark.parametrize("path", list(bv.PATHS))
def test_path_matches_jax(batches, path):
    (rstore, *rbatch), (store, *batch) = batches
    want, want_perm = _jax_path(path, rstore, *rbatch)
    wl = bv.prepare(path, store, *batch).to("cpu")
    sl = bv.centred_slice(len(wl), SLICE)
    got = wl.verify(sl)
    assert got.dtype == torch.bool and got.shape == (SLICE,)
    np.testing.assert_array_equal(got.numpy(), want)
    if want_perm is None:
        assert wl.perm is None
    else:
        np.testing.assert_array_equal(wl.perm, want_perm)
    live = wl.n[sl].numpy() > 0
    assert got.numpy()[live].any() and not got.numpy()[live].all()


def test_fused_mxu3_needs_k5_over_256_bp():
    """fused_mxu3 with reads over 256 bp selects K5 over the 32-word table,
    as bench.py:184-190 does, and fails where bench.py fails: K5 takes
    n_words <= 16 (the reference asserts it)."""
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    seqs = [genome[s:s + 300] for s in rng.integers(0, 1700, 20)]
    store = ReadStore.from_sequences(seqs)
    assert store.n_words > 16
    assert RefReadStore.from_sequences(seqs).n_words == store.n_words
    z = np.zeros(4, np.int32)
    layout, fn = bv.route("fused_mxu3", store.n_words)
    assert fn is bv.fk.verify_windows_fused_mxu_both
    wl = bv.prepare("fused_mxu3", store, z, z, z, z, z).to("cpu")
    assert wl.table.shape[1] == 128
    assert wl.packed.shape == (40, store.n_words + 1)
    with pytest.raises(AssertionError):
        jfk.verify_windows_fused_mxu_both(
            jfk.pack_lines(wl.packed)[0], z, z, z, z, z,
            n_words=store.n_words, interpret=True)
    with pytest.raises(ValueError, match="n_words <= 16"):
        wl.verify()
    bv.prepare("fused_mxu", store, z, z, z, z, z).to("cpu").verify()


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bv.main(["--path", "fused"])
    with pytest.raises(ValueError, match="CUDA card"):
        bv.main(["--device", "cpu"])
