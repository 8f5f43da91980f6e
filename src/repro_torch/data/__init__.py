from repro_torch.data.synthetic import recsys_batch_stream

__all__ = ["recsys_batch_stream"]
