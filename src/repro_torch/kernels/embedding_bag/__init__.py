from repro_torch.kernels.embedding_bag.ops import (embedding_bag_kernel,
                                                  embedding_bag_ref)

__all__ = ["embedding_bag_kernel", "embedding_bag_ref"]
