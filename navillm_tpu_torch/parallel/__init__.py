"""Data and tensor parallelism over torch.distributed (twins of
navillm_tpu/parallel): the (data, model) process grid, the partition
specs, the local shards, ZeRO-1 and the TP collectives (mesh.py); process
start-up under torchrun and the padded-pickle object gather of validation
(dist.py)."""
