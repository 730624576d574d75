from .latent_dataset import ImgLatentDataset, LatentShardWriter, read_safetensors, write_safetensors

__all__ = ["ImgLatentDataset", "LatentShardWriter", "read_safetensors", "write_safetensors"]
