from repro_torch.data.synthetic import (gnn_graph_batch, lm_batch_stream,
                                        neighbor_sampled_batch,
                                        recsys_batch_stream)

__all__ = ["lm_batch_stream", "recsys_batch_stream", "gnn_graph_batch",
           "neighbor_sampled_batch"]
