"""Back-compat shim, as in the reference: the Alg 1 / Alg 2
partition-level primitives live in ``repro_torch.dist.setup``; this module
re-exports them."""

from repro_torch.dist.setup import (distributed_aggregate,
                                    distributed_select_eliminated,
                                    distributed_unweighted_degrees,
                                    distributed_vote_round)

__all__ = [
    "distributed_aggregate",
    "distributed_select_eliminated",
    "distributed_unweighted_degrees",
    "distributed_vote_round",
]
