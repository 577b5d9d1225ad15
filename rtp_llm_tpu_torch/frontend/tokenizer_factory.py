"""Tokenizer construction (port of ``rtp_llm_tpu/frontend/tokenizer_factory.py``).

The tokenizer is optional: ``transformers`` is imported only here, lazily.
Without it (or without tokenizer files) ``create`` returns None and the
server answers text routes with 400 while token-id prompts are still served.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class TokenizerFactory:
    @staticmethod
    def create(tokenizer_path: str, trust_remote_code: bool = True):
        try:
            from transformers import AutoTokenizer
        except ImportError:
            logger.warning("transformers is not installed: serving token ids only")
            return None
        try:
            return AutoTokenizer.from_pretrained(tokenizer_path,
                                                 trust_remote_code=trust_remote_code)
        except (OSError, ValueError) as e:
            logger.warning("no tokenizer at %s (%s): serving token ids only",
                           tokenizer_path, e)
            return None
