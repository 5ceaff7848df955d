"""Multi-device paths on ``torch.distributed`` (port of
``spatialsim_tpu/parallel/``): the bodies axis as a process group
(:mod:`.mesh`), the collectives (:mod:`.collectives`), the distributed
sample sort (:mod:`.distsort`) and the sharded engines and steps
(:mod:`.sharded`).  One process a device; every function takes and returns
this rank's shard.  ``python -m spatialsim_tpu_torch.parallel.dryrun``
runs one sharded step of each engine and of the boids step (under
``torchrun`` on several cards)."""

from spatialsim_tpu_torch.parallel.mesh import (  # noqa: F401
    BODY_AXIS, BodyMesh, make_mesh)
from spatialsim_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_boids_step, make_sharded_step, make_sharded_window_step,
    ring_allpairs_accel, shard_state, sharded_barnes_hut_accel)
