"""The SPMD layer: device meshes, the sharding rules, the step functions
and the production-mesh dry-run (`python -m repro_torch.launch.dryrun`)."""
