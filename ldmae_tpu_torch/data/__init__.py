from .latent_dataset import ImgLatentDataset, read_safetensors

__all__ = ["ImgLatentDataset", "read_safetensors"]
