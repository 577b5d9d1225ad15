from rtp_llm_tpu_torch.loader.loader import CheckpointLoader, SafetensorsFile

__all__ = ["CheckpointLoader", "SafetensorsFile"]
