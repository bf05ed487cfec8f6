from repro_torch.serving import aes_function, batcher, engine, kvcache, sampling
from repro_torch.serving.aes_function import AesFunction
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import PagedKVManager

__all__ = ["aes_function", "batcher", "engine", "kvcache", "sampling", "AesFunction",
           "ContinuousBatcher", "Request", "ServingEngine", "PagedKVManager"]
