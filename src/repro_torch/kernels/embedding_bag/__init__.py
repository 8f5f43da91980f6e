from repro_torch.kernels.embedding_bag.ops import (BagGradPlan, BagSum,
                                                  ScatterAdd, ScatterSum,
                                                  bag_grad_layout,
                                                  bag_grad_plan,
                                                  bag_grad_plan_ref,
                                                  bag_wide_layout,
                                                  embedding_bag_backward,
                                                  embedding_bag_backward_ref,
                                                  embedding_bag_kernel,
                                                  embedding_bag_ref)

__all__ = ["BagGradPlan", "BagSum", "ScatterAdd", "ScatterSum",
           "bag_grad_layout", "bag_grad_plan", "bag_grad_plan_ref",
           "bag_wide_layout", "embedding_bag_backward",
           "embedding_bag_backward_ref", "embedding_bag_kernel",
           "embedding_bag_ref"]
