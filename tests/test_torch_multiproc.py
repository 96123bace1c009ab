"""The port's one-process-per-rank buildG (disco_tpu_torch.dist.multiproc)
on the CPU: real processes under gloo, each holding one or two CPU shards,
against the reference's goldens, the port's one-process mesh
(dist/mesh.py, dist/builder.py) and disco_tpu's multiproc helpers.  The
ranks run the kernels' plain versions.  Tolerance: exact — integers,
booleans, byte-identical files."""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import GOLDEN
from disco_tpu.dist import multiproc as jmultiproc
from disco_tpu_torch.dist import builder, mesh as tmesh, multiproc
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore

ROOT = pathlib.Path(__file__).resolve().parent.parent
MINI = GOLDEN / "mini"
FIELDS = ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok")
FILES = ("_0_parGraph.txt", "_0_containedReads.txt", "_0_startRead.txt",
         "_CheckpointInfo.txt", "_ReadIDMap.txt")
# the relation test's chunking (several chunks of mini) and its cases: the
# default caps, and caps that overflow into the exact re-run
BUDGET = 1 << 16
CASES = {"caps": {}, "route_cap": {"route_cap": 8}, "hit_cap": {"hit_cap": 2}}

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    # a scheduler's variables would name another world (derive_cluster_env)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "OMPI_COMM_WORLD_",
                                "DISCO_TPU_COORDINATOR"))}
    env["PYTHONPATH"] = str(ROOT) + ":" + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(argvs, cwds, logs, envs=None):
    """One process per argv, each in its cwd, its output to a file in
    `logs` (a pipe that no one reads could fill and stall a rank, and its
    peers with it); waits for all (300 s each) and fails with a rank's
    output if any exits non-zero."""
    files = [open(logs / f"rank{r}.log", "w+") for r in range(len(argvs))]
    try:
        envs = envs or [{}] * len(argvs)
        procs = [subprocess.Popen([sys.executable, *argv],
                                  env={**_env(), **e}, cwd=cwd, stdout=f,
                                  stderr=subprocess.STDOUT)
                 for argv, cwd, f, e in zip(argvs, cwds, files, envs)]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, f) in enumerate(zip(procs, files)):
            f.seek(0)
            assert p.returncode == 0, f"rank {rank} failed:\n" \
                f"{f.read()[-3000:]}"
    finally:
        for f in files:
            f.close()


def _script(code, *args):
    return ["-c", code, *map(str, args)]


# ---------------------------------------------------------------------------
# buildG files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rma", [False, True], ids=["replicated", "rma"])
@pytest.mark.parametrize("ranks,local", [(2, 1), (2, 2), (4, 1)],
                         ids=["2x1", "2x2", "4x1"])
def test_ranks_buildg_matches_golden(ranks, local, rma, tmp_path,
                                     monkeypatch):
    """`python -m disco_tpu_torch.dist.multiproc` in `ranks` processes of
    `local` CPU shards each: rank 0's files equal the reference's goldens
    and the one-process run_buildg_sharded's at the same shard count, and
    the other ranks write nothing."""
    port = _free_port()
    outs = [tmp_path / f"r{r}" for r in range(ranks)]
    for d in outs:
        d.mkdir()
    extra = ["-rma"] if rma else []
    argvs = [["-m", "disco_tpu_torch.dist.multiproc", "--coordinator",
              f"127.0.0.1:{port}", "--num-processes", str(ranks),
              "--process-id", str(r), "--local-devices", str(local), "-pe",
              "reads.fasta", "-f", str(outs[r] / "MP"), "-m-ovl", "30",
              "-w", "1000", *extra] for r in range(ranks)]
    # from the golden's directory: _ReadIDMap.txt records the path as given
    _run_ranks(argvs, [MINI] * len(argvs), tmp_path)
    monkeypatch.chdir(MINI)
    builder.run_buildg_sharded(["reads.fasta"], [], str(tmp_path / "one"),
                               ranks * local, dist_mem=rma, device="cpu")
    for suffix in FILES:
        got = (outs[0] / f"MP{suffix}").read_bytes()
        assert got == (MINI / f"mini{suffix}").read_bytes(), suffix
        assert got == (tmp_path / f"one{suffix}").read_bytes(), suffix
    assert not any(list(d.iterdir()) for d in outs[1:])


def test_ranks_from_torchrun_environment(tmp_path):
    """With no coordinator, process count or id, each rank initialises
    from the environment torchrun sets (`env://`: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE; LOCAL_RANK picks a card): rank 0's
    graph equals the golden's."""
    port = _free_port()
    argv = ["-m", "disco_tpu_torch.dist.multiproc", "--local-devices", "1",
            "-pe", "reads.fasta", "-f", str(tmp_path / "T")]
    envs = [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2"}
            for r in range(2)]
    (tmp_path / "logs").mkdir()
    _run_ranks([argv, argv], [MINI, MINI], tmp_path / "logs", envs)
    for suffix in FILES:
        assert ((tmp_path / f"T{suffix}").read_bytes()
                == (MINI / f"mini{suffix}").read_bytes()), suffix


# ---------------------------------------------------------------------------
# the relation, with and without overflow
# ---------------------------------------------------------------------------
RELATIONS = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from disco_tpu_torch.dist.mesh import process_mesh
from disco_tpu_torch.dist.multiproc import (exit_rank,
                                            sharded_relation_multiproc)
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore

port, rank, local, dist_mem, out = sys.argv[1:]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=2, rank=int(rank))
store = ReadStore.from_files([{fasta!r}], [], 30,
                             reference_task_order=False)
table = FingerprintTable.build(store, 29)
mesh = process_mesh(int(local), torch.device("cpu"))
res = {{}}
for case, kw in {cases!r}.items():
    rel = sharded_relation_multiproc(store, table, mesh, budget={budget},
                                     dist_mem=dist_mem == "1", **kw)
    for f in {fields!r}:
        res[case + ":" + f] = getattr(rel, f)
    res[case + ":stats"] = np.array([rel.stats["chunks"],
                                     rel.stats["fallback_chunks"]])
np.savez(out, **res)
dist.destroy_process_group()
exit_rank(0)
"""


@pytest.fixture(scope="module")
def mini_state():
    store = ReadStore.from_files([str(MINI / "reads.fasta")], [], 30,
                                 reference_task_order=False)
    return store, FingerprintTable.build(store, 29)


@pytest.fixture(scope="module")
def rank_relations(tmp_path_factory):
    """Each mode's relations of every case from two ranks of two CPU
    shards (one launch a mode): {dist_mem: [rank 0's, rank 1's]}."""
    code = RELATIONS.format(fasta=str(MINI / "reads.fasta"), cases=CASES,
                            budget=BUDGET, fields=FIELDS)
    res = {}
    for dist_mem in (False, True):
        tmp = tmp_path_factory.mktemp(f"rel{int(dist_mem)}")
        port = _free_port()
        npz = [tmp / f"rank{r}.npz" for r in range(2)]
        _run_ranks([_script(code, port, r, 2, int(dist_mem), npz[r])
                    for r in range(2)], [tmp, tmp], tmp)
        res[dist_mem] = [dict(np.load(p)) for p in npz]
    return res


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dist_mem", [False, True], ids=["replicated",
                                                          "dist_mem"])
def test_relation_matches_one_process(rank_relations, mini_state, dist_mem,
                                      case):
    """sharded_relation_multiproc over 2 ranks x 2 shards equals the
    one-process sharded_relation on 4 shards, row for row, on both ranks,
    with the same chunk and fallback counts.  With route_cap 8 or hit_cap
    2 every rank re-runs the overflowing chunks exactly, and takes the
    same decisions."""
    store, table = mini_state
    stats = {}
    want = builder.sharded_relation(store, table, tmesh.make_mesh(4, "cpu"),
                                    budget=BUDGET, dist_mem=dist_mem,
                                    stats=stats, **CASES[case])
    for rank, got in enumerate(rank_relations[dist_mem]):
        for f in FIELDS:
            a, b = got[f"{case}:{f}"], getattr(want, f)
            assert a.dtype == b.dtype, (rank, f)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} {f}")
        assert got[f"{case}:stats"].tolist() == [stats["chunks"],
                                                  stats["fallback_chunks"]]
    assert stats["chunks"] > 2
    assert (stats["fallback_chunks"] > 0) == (case != "caps")


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
COLLECTIVES = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from disco_tpu_torch.dist import mesh as tmesh
from disco_tpu_torch.dist.multiproc import exit_rank

port, rank, inputs, out = sys.argv[1:]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=2, rank=int(rank))
inputs = np.load(inputs)
res = {}
for local in (1, 2):
    mesh = tmesh.process_mesh(local, torch.device("cpu"))
    for name in ("int32", "int64", "bool"):
        xs = [torch.from_numpy(inputs[f"{local}:{name}:{s}"])
              for s in mesh.shards]
        for d, (a, g) in enumerate(zip(tmesh.all_to_all(mesh, xs),
                                       tmesh.all_gather(mesh, xs))):
            res[f"{local}:{name}:a2a:{d}"] = a.numpy()
            res[f"{local}:{name}:gather:{d}"] = g.numpy()
        res[f"{local}:{name}:host"] = tmesh.gather_host(mesh, xs)
np.savez(out, **res)
dist.destroy_process_group()
exit_rank(0)
"""
DTYPES = ("int32", "int64", "bool")


def _shard_inputs(local, name):
    """Each of the 2 * local shards' input: 6 rows a shard of every shard's
    blocks, 3 columns, from a seed; int32 wraps, bool the even values."""
    n = 2 * local
    out = []
    for s in range(n):
        x = np.random.default_rng(s).integers(-2**40, 2**40, (n * 6, 3))
        out.append(torch.from_numpy(x % 2 == 0 if name == "bool"
                                    else x.astype(name)))
    return out


@pytest.fixture(scope="module")
def rank_collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{f"{local}:{name}:{s}": x.numpy()
                        for local in (1, 2) for name in DTYPES
                        for s, x in enumerate(_shard_inputs(local, name))})
    port = _free_port()
    npz = [tmp / f"rank{r}.npz" for r in range(2)]
    _run_ranks([_script(COLLECTIVES, port, r, inputs, npz[r])
                for r in range(2)], [tmp, tmp], tmp)
    return [dict(np.load(p)) for p in npz]


@pytest.mark.parametrize("name", DTYPES)
def test_collectives_match_one_process(rank_collectives, name):
    """all_to_all, all_gather and gather_host across 2 ranks of 1 and 2
    shards each equal the one-process mesh's on the same inputs, for every
    local shard (bool rides the collectives as uint8)."""
    for local in (1, 2):
        n = 2 * local
        xs = _shard_inputs(local, name)
        one = tmesh.make_mesh(n, "cpu")
        a2a, gathered = tmesh.all_to_all(one, xs), tmesh.all_gather(one, xs)
        for rank, got in enumerate(rank_collectives):
            for d in range(local):
                s = rank * local + d
                for kind, want in (("a2a", a2a[s]), ("gather", gathered[s])):
                    a = got[f"{local}:{name}:{kind}:{d}"]
                    assert a.dtype == want.numpy().dtype, (kind, name)
                    np.testing.assert_array_equal(a, want.numpy(),
                                                  err_msg=kind)
            np.testing.assert_array_equal(got[f"{local}:{name}:host"],
                                          tmesh.gather_host(one, xs))


# ---------------------------------------------------------------------------
# no fallback; the launch environment
# ---------------------------------------------------------------------------
def test_without_a_card_main_raises(tmp_path):
    """Without a card and without --local-devices, main raises before any
    process group forms, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the ranks take it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multiproc.main(["--coordinator", f"127.0.0.1:{_free_port()}",
                        "--num-processes", "2", "--process-id", "0",
                        "-pe", str(MINI / "reads.fasta"),
                        "-f", str(tmp_path / "x")])
    assert not dist.is_initialized()
    assert not list(tmp_path.iterdir())


CLUSTER_ENVS = {
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
              "SLURM_JOB_NODELIST": "tpu[004-011]"},
    "slurm_step": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
                   "SLURM_JOB_NODELIST": "tpu[004-011]",
                   "SLURM_STEP_NUM_TASKS": "4",
                   "SLURM_STEP_NODELIST": "tpu[006-009]",
                   "DISCO_TPU_PORT": "9999"},
    "slurm_coordinator": {"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
                          "SLURM_JOB_NODELIST": "n[17,19-22],m01",
                          "DISCO_TPU_COORDINATOR": "10.0.0.5:1234"},
    "slurm_no_nodelist": {"SLURM_PROCID": "0"},
    "ompi": {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
             "DISCO_TPU_COORDINATOR": "head:8476"},
    "ompi_no_coordinator": {"OMPI_COMM_WORLD_RANK": "0",
                            "OMPI_COMM_WORLD_SIZE": "2"},
    "empty": {},
}
NODELISTS = ("tpu003", "tpu[003-006,010]", "n[17,19-22],m01", "a7,b[1-2]",
             "gpu[7]")


@pytest.mark.parametrize("case", list(CLUSTER_ENVS) + [
    f"nodelist:{n}" for n in NODELISTS])
def test_cluster_env_matches_jax(case):
    """derive_cluster_env and first_slurm_host are disco_tpu's, copied:
    the same results on tests/test_cluster_env.py's SLURM, OpenMPI and
    empty environments and nodelists."""
    if case.startswith("nodelist:"):
        nodelist = case.split(":", 1)[1]
        assert (multiproc.first_slurm_host(nodelist)
                == jmultiproc.first_slurm_host(nodelist))
        return
    env = CLUSTER_ENVS[case]
    assert (multiproc.derive_cluster_env(dict(env))
            == jmultiproc.derive_cluster_env(dict(env)))


def test_multicard_raises_without_a_card(monkeypatch):
    """tools/multicard.py measures cards: without one it raises before it
    reads anything; a rank that failed or printed no record fails it."""
    from disco_tpu_torch.tools import multicard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        multicard.main(["--fasta", "missing.fasta"])
    assert multicard.rank_records([(0, 'x\nRANK {"rows": 3}\n')]) == [
        {"rows": 3}]
    with pytest.raises(RuntimeError, match="rank 1 exited 1"):
        multicard.rank_records([(0, 'RANK {"rows": 1}'), (1, "boom")])
    with pytest.raises(RuntimeError, match="rank 0 exited 0"):
        multicard.rank_records([(0, "no record")])
