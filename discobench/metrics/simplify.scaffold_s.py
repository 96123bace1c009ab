"""simplify.scaffold_s: seconds a job spends scaffolding (simplify.scaffold;
the `clock` stage scaffold), averaged over the window's jobs."""


def read(run):
    return run.stage_mean(("scaffold",))
