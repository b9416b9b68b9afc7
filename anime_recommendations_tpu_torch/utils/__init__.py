from anime_recommendations_tpu_torch.utils.text import clean_name, clean_names

__all__ = ["clean_name", "clean_names"]
