from anime_recommendations_tpu_torch.data.catalog import Catalog
from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
from anime_recommendations_tpu_torch.data.vocab import Vocab, build_vocab

__all__ = ["Catalog", "Vocab", "build_vocab", "preprocess_ratings"]
