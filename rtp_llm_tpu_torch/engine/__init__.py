from rtp_llm_tpu_torch.engine.engine import LlmEngine
from rtp_llm_tpu_torch.engine.stream import FinishReason, GenerateStream, StreamState

__all__ = ["LlmEngine", "GenerateStream", "FinishReason", "StreamState"]
