"""index.insert_s: seconds a job spends building the fingerprint table of
read ends (index.table; the `clock` stage insertDataset), averaged over
the window's jobs."""


def read(run):
    return run.stage_mean(("insertDataset",))
