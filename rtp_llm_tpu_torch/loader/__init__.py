from rtp_llm_tpu_torch.loader.loader import CheckpointLoader, SafetensorsFile, load_eagle_weights

__all__ = ["CheckpointLoader", "SafetensorsFile", "load_eagle_weights"]
