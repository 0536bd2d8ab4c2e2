"""Tensor-parallel serving over ``torch.distributed``: the mesh record and
shard policy (:mod:`.axes`) and the sharding rules (:mod:`.sharding`)."""
