"""Graph-simplification layer: the reference's SimplifyGraph executables
(`fullsimplify`, `parsimplify`; reference: src/SimplifyGraph/), the port's
copy of disco_tpu/simplify.  These are sequential graph algorithms on
Python objects, numpy arrays and the C++ host code of native/src; nothing
here runs on the card.

Structure:
- core        Edge model, inner-read rope, deterministic ordered graph
- pargraph    parsimplify equivalent (per-partition contraction + dead ends)
- engine      fullsimplify equivalent (operators, flow, contigs, scaffolds)
- flow        min-cost-flow problem generation + native MCMF solver
- params      parameter sets mirroring the reference's cfg semantics
"""
