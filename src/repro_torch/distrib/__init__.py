"""Distribution layer of the port (the port of ``repro.distrib``):
``sharding`` names the mesh's axes and holds the per-architecture
partition rules, ``collectives`` the cross-shard operations over lists
of per-shard tensors, ``hints`` the activation sharding hints, and
``elastic`` the restore of any checkpoint onto any mesh.

One process drives every shard, as the JAX engine's single controller
drives its mesh; the serving collectives are copies between devices and
exact reductions, so a sharded result is the unsharded one bit for
bit.  The dry run (``launch/dryrun.py``) lays the same rules over a fake
process group of 256 or 512 ranks with ``torch.distributed.tensor``."""
