"""Multi-device: the named mesh, the logical-axis sharding rules and the
rank launcher (one process per shard, ``torch.distributed``)."""
