"""repro_torch.dist — the mesh executor over a torch.distributed group,
and the partitioning rules of the mesh paths.

`collectives` holds the executor (`MeshExecutor`, `axis_executor`) and
its collectives (all-gather, psum, pmean, ppermute, the ring combines);
`sharding` the rule of which leaves of a session's state are
row-sharded, and the LM partitioning policy over a `DeviceMesh` (specs,
DTensor placements, the ambient mesh and its constraints).
"""
from repro_torch.dist import collectives, sharding  # noqa: F401
from repro_torch.dist.collectives import MeshExecutor  # noqa: F401
