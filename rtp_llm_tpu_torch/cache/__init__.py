from rtp_llm_tpu_torch.cache.block_pool import BlockPool
from rtp_llm_tpu_torch.cache.kv_cache_manager import BlockAllocation, KVCacheManager
from rtp_llm_tpu_torch.cache.prefix_cache import PrefixBlockCache, chain_hashes

__all__ = ["BlockPool", "BlockAllocation", "KVCacheManager", "PrefixBlockCache",
           "chain_hashes"]
