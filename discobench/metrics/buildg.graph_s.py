"""buildg.graph_s: seconds a job spends replaying the reference's
containment scan and graph traversal over the relation (buildg.replay; the
`clock` stages markContainedReads and buildOverlapGraphFromHashTable),
averaged over the window's jobs."""


def read(run):
    return run.stage_mean(("markContainedReads",
                           "buildOverlapGraphFromHashTable"))
