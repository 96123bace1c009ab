"""io.read_s: seconds a job spends reading its reads into the packed read
store (io.readstore; the program's `clock` stage readDataset), averaged
over the window's jobs."""


def read(run):
    return run.stage_mean(("readDataset",))
