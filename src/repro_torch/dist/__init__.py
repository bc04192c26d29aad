"""repro_torch.dist — the mesh executor over a torch.distributed group.

`collectives` holds the executor (`MeshExecutor`) and its collectives
(all-gather, psum, pmean, ppermute, the ring combines); `sharding` the
rule of which leaves of a session's state are row-sharded.
"""
from repro_torch.dist import collectives, sharding  # noqa: F401
from repro_torch.dist.collectives import MeshExecutor  # noqa: F401
