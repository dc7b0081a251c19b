"""Sharded serving across devices (the port of ``repro.distrib``, its
serving subset): ``sharding`` names the mesh's axes, ``collectives``
holds the cross-shard operations over lists of per-shard tensors.

One process drives every shard, as the JAX engine's single controller
drives its mesh; the collectives are copies between devices and exact
reductions, so a sharded result is the unsharded one bit for bit."""
