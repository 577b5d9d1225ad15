from rtp_llm_tpu_torch.models.batch import ModelInputs, ModelOutputs
from rtp_llm_tpu_torch.models.llama_family import LlamaFamilyModel

__all__ = ["LlamaFamilyModel", "ModelInputs", "ModelOutputs"]
