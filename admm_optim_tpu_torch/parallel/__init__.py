"""The multi-device layer (port of admm_optim_tpu/parallel): one process
per shard under torch.distributed in place of the JAX package's
shard_map regions (launch, sharding, patch_shard)."""
