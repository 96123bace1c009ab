"""The fetch experiments of tools/ on one CUDA card, each run as `python -m
disco_tpu_torch.tools.<name>`: exp_fetch_variants (with the wrappers of
T1, `verify_sync`, and T2, `verify_pipe_nc`), exp_mxu_fetch (with T3,
`fetch_checksum`) and exp_locality."""
