from repro_torch.models.recsys.embedding import embedding_bag, hashed_lookup
from repro_torch.models.recsys.deepfm import (DeepFM, DeepFMConfig,
                                              deepfm_forward, deepfm_loss,
                                              default_vocabs,
                                              fm_retrieval_scores,
                                              init_deepfm)

__all__ = ["embedding_bag", "hashed_lookup", "DeepFM", "DeepFMConfig",
           "deepfm_forward", "deepfm_loss", "default_vocabs",
           "fm_retrieval_scores", "init_deepfm"]
