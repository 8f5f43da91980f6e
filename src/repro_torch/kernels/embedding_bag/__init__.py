from repro_torch.kernels.embedding_bag.ops import (BagSum,
                                                  embedding_bag_backward,
                                                  embedding_bag_backward_ref,
                                                  embedding_bag_kernel,
                                                  embedding_bag_ref)

__all__ = ["BagSum", "embedding_bag_backward", "embedding_bag_backward_ref",
           "embedding_bag_kernel", "embedding_bag_ref"]
