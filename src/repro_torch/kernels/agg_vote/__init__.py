from repro_torch.kernels.agg_vote.ops import (vote_reduce,
                                              vote_reduce_batched,
                                              vote_reduce_batched_ref,
                                              vote_reduce_ref)

__all__ = ["vote_reduce", "vote_reduce_batched", "vote_reduce_batched_ref",
           "vote_reduce_ref"]
