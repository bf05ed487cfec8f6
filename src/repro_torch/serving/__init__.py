from repro_torch.serving import batcher, engine, kvcache, sampling
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import PagedKVManager

__all__ = ["batcher", "engine", "kvcache", "sampling", "ContinuousBatcher",
           "Request", "ServingEngine", "PagedKVManager"]
