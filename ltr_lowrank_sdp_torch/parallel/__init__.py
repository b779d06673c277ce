"""The parallel modes on ``torch.distributed``: the (batch, constr) mesh,
the constraint-sharded conic operators and the batched MaxCut ALM steps."""

from .mesh import Mesh, make_mesh  # noqa: F401
