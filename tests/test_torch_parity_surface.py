"""Every function of disco_tpu has a counterpart in disco_tpu_torch: each
top-level function, class and method of disco_tpu/**/*.py (read with
`ast`, nothing imported) has a same-named one in the matching
disco_tpu_torch/ file, or stands below among the deliberate differences,
each with its reason.  Any other gap fails."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "disco_tpu"
PORT = ROOT / "disco_tpu_torch"

_PALLAS = "a Pallas kernel body or BlockSpec helper: the CUDA kernels " \
          "(csrc/) take its place"
_ALIGN = "a Pallas helper of the word roll and masked compare: " \
         "csrc/window.cuh's device functions take its place"
_PAD = "pads the pairs to whole Pallas tiles: the CUDA kernels take any P"
_LOADER = "builds or loads disco_tpu's libraries in its package: the " \
          "port's loader is native.__init__._lib over kernels.py's build " \
          "directory"
_GRID = "the hit-cap grid engine: no path of either package's CLI runs " \
        "it; the port's one step is device_overlap_rows"
_WIRE = "disco_tpu's wire rows: the port's relation keeps its rows as " \
        "columns on the card (device_overlap_rows, dense_row_chunks)"

DIFFERENCES = {
    "overlap/device.py": {
        "DeviceOverlapResult": _GRID,
        "DeviceCompactResult": _GRID,
        "device_overlap": _GRID,
        "device_overlap_compact": _GRID,
        "device_overlap_packed": _GRID,
        "DeviceOverlapEngine.run": _GRID,
        "DeviceOverlapEngine.run_chunked": _GRID,
        "DeviceOverlapEngine.run_compact": _GRID,
        "DeviceOverlapEngine.run_packed": _GRID,
        "DeviceOverlapEngine.run_packed_chunked": _GRID,
        "DeviceOverlapEngine.window_starts": "the grid's window ids of the "
                                             "whole set on the host: the "
                                             "port makes each chunk's on "
                                             "the card (window_starts_at)",
        "device_overlap_dense": _WIRE,
        "device_overlap_dense32": _WIRE,
        "DeviceOverlapEngine.run_dense": _WIRE,
        "DeviceOverlapEngine.run_dense32": _WIRE,
        "DeviceOverlapEngine.run_dense_chunked": _WIRE,
        "DeviceOverlapEngine.run_dense32_chunked": _WIRE,
    },
    "overlap/fused_kernel.py": {
        "_dual_kernel": _PALLAS,
        "_fused_kernel": _PALLAS,
        "_mxu_prep": "the MXU-fetch kernels' per-tile line-block set-up: "
                     "the port's fetch kernels read rows by index",
        "_mxu2_kernel": _PALLAS,
        "_mxu2_dual_kernel": _PALLAS,
        "_mxu3_kernel": _PALLAS,
        "_mxu3_16_kernel": _PALLAS,
        "_expand_rows": "the one-hot MXU row expansion: a CUDA kernel loads "
                        "rows by index",
        "_expand_rows16": "the one-hot MXU row expansion (16 words)",
        "_expand_rows_bs": "the one-hot MXU row expansion (blocked)",
        "_row_spec": _PALLAS,
        "_line_specs": _PALLAS,
        "_win_specs": _PALLAS,
        "_win_specs16": _PALLAS,
        "_split_off": _ALIGN,
        "_align": _ALIGN,
        "_masked_cmp": _ALIGN,
        "_roll_up": _ALIGN,
        "_pad_pairs": _PAD,
        "fused_compare_dual_mxu": "ported as fused_compare_dual_fetch (K2): "
                                  "it fetches read1's rows from packed_all, "
                                  "not from 128-lane line blocks",
    },
    "overlap/pallas_kernel.py": {"_compare_kernel": _PALLAS},
    "cli.py": {
        "_prepare_devices": "makes virtual JAX CPU devices for -n; the port "
                            "raises without a card instead (ROADMAP "
                            "Queue 3)",
    },
    "dist/multiproc.py": {
        "_global_arrays": "assembles jax.Arrays over a multi-process mesh; "
                          "a port rank holds torch tensors of its own "
                          "shards (mesh.process_mesh)",
    },
    "dist/overlap_shard.py": {
        "ShardedOverlapEngine.shard_fn": "the shard_map body: a port "
                                         "engine steps its shards in a loop "
                                         "(make_step)",
        "DistMemOverlapEngine.shard_fn": "the shard_map body (make_step)",
        "DistMemOverlapEngine.build": "inherited: the port's "
                                      "ShardedOverlapEngine.build builds "
                                      "both engines",
        "DistMemOverlapEngine._resolve_fetch_cap": "restructured as "
                                                   "fetch_cap_for",
    },
    "native/__init__.py": {
        "_compile": _LOADER, "_build_and_load": _LOADER,
        "_overlap_lib": _LOADER, "_readqc_lib": _LOADER,
        "_replay_lib": _LOADER, "_parsimplify_lib": _LOADER,
        "_mcmf_lib": _LOADER, "_backindex_lib": _LOADER,
        "_seq_scan_window_bind": "binds seq_scan's argtypes at first "
                                 "use; the port's _lib binds every "
                                 "function's from one table as it loads",
    },
}


def _surface(path: pathlib.Path) -> set:
    """Top-level functions and classes, and Class.method names."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))
    return names


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_function_has_a_counterpart(module):
    port = PORT / module
    assert port.exists(), f"disco_tpu_torch/{module} is missing"
    missing = _surface(REF / module) - _surface(port)
    listed = DIFFERENCES.get(module, {})
    gaps = sorted(missing - set(listed))
    assert not gaps, f"disco_tpu_torch/{module} lacks {gaps}"


def test_differences_are_real_and_reasoned():
    """Each listed difference is a name of disco_tpu that the port does not
    have, with a reason; a counterpart that appears later must leave the
    list."""
    for module, names in DIFFERENCES.items():
        missing = _surface(REF / module) - _surface(PORT / module)
        for name, reason in names.items():
            assert name in missing, f"{module}: {name} is not a gap"
            assert reason.strip(), f"{module}: {name} has no reason"
