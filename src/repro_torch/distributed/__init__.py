"""Meshes over ``torch.distributed`` for tensor-parallel serving and for
training on a data x model mesh: the mesh records, shard policies and
collectives (:mod:`.axes`) and the sharding rules and placements
(:mod:`.sharding`)."""
