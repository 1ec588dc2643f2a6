"""Device meshes, FSDP and tensor-parallel sharding, ring attention and
optimizer offload over `torch.distributed` (one process per card)."""
