"""simplify.fullsimplify_s: seconds a job spends in fullsimplify
(simplify.driver: every `clock` stage of its iterations), averaged over the
window's jobs."""

STAGES = ("parSimplifyAndLoad", "graphPathFindInitial", "simplifyGraph",
          "calculateFlowStream", "postFlowSimplify", "streamContigs",
          "scaffold", "streamScaffolds")


def read(run):
    return run.stage_mean(STAGES)
