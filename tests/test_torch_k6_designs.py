"""The designs of K6's kernel that tools/exp_k6_designs.py times
(csrc/k6_designs.cu), on the CPU:

- the staged designs' worst bank conflict over 32 rows is what the
  source's comment states: none at the odd stride 17 of the 4-B
  copies, 4-way at stride 20 of the 16-B copies;
- no layout the 16-B copies allow (a stride that is a multiple of 4 words,
  with or without a swizzle of 16-B chunks within a row) does better than
  4-way: a word stays on the banks of its word mod 4;
- the tool's design ids and the source's table of kernels agree;
- on CPU tensors each design gives the plain version's booleans.
The kernels themselves run in tests/test_torch_cuda.py on a card."""
import re

import numpy as np
import pytest
import torch

from disco_tpu_torch import kernels
from disco_tpu_torch.overlap import fused_kernel as fk
from disco_tpu_torch.tools import exp_k6_designs as kd

SOURCE = kernels.CSRC / "k6_designs.cu"


@pytest.mark.parametrize("stride,worst", [(17, 1), (20, 4)])
def test_staged_bank_conflicts_are_as_stated(stride, worst):
    assert max(kd.bank_conflict(stride, w) for w in range(17)) == worst
    assert f"kStride {stride}" in SOURCE.read_text()


@pytest.mark.parametrize("stride", range(16, 68, 4))
def test_no_16_byte_layout_beats_4_way(stride):
    rng = np.random.default_rng(stride)
    perms = [None, lambda s, q: q ^ (s & 3), lambda s, q: (q + s) % 4,
             lambda s, q: np.array([rng.permutation(4) for _ in s])[
                 np.arange(len(s)), q]]
    for swizzle in perms:
        assert min(kd.bank_conflict(stride, w, swizzle=swizzle)
                   for w in range(16)) >= 4


def test_design_ids_match_the_source():
    text = SOURCE.read_text()
    table = dict((name, int(i)) for i, name in re.findall(
        r"//\s*(\d+)\s+(\w+)\s*$", text, re.M))
    assert table == {name: ident for name, (ident, _) in kd.DESIGNS.items()}
    assert sorted(table.values()) == list(range(len(kd.DESIGNS)))


def test_designs_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    table = rng.integers(-2 ** 31, 2 ** 31, (64, 16)).astype(np.int32)
    p = 500
    i = np.arange(p)
    r1 = np.sort(rng.integers(0, 64, p))
    r2 = np.where(i % 4 == 0, r1, rng.integers(0, 64, p))
    o1 = rng.integers(0, 16, p) * 16 | (i & 15)
    o2 = np.where(i % 4 == 0, o1, rng.integers(0, 16, p) * 16 | (i >> 4) & 15)
    n = np.minimum(256 - np.maximum(o1, o2), rng.integers(0, 257, p))
    t = [torch.from_numpy(np.ascontiguousarray(x, np.int32))
         for x in (table.reshape(-1, 128), r1, r2, o1, o2, n)]
    want = fk.verify_windows_fused_mxu_both16_plain(*t, n_words=16)
    assert want.any() and not want.all()
    for name in (*kd.DESIGNS, "kept", "direct"):
        got = kd.design(name, *t, n_words=16)
        assert torch.equal(got, want), name
    with pytest.raises(ValueError, match="256 bp"):
        kd.design("lanes8", *t, n_words=17)
