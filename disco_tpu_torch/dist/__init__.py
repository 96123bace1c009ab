"""The distributed buildG over a mesh of shards (the counterpart of
disco_tpu/dist/): dist.mesh, dist.overlap_shard and dist.builder, in one
process or, through dist.multiproc, one process per rank."""
