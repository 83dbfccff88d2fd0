from cullavo_tpu_torch.serving.engine import Request, ServingEngine
from cullavo_tpu_torch.serving.server import EngineRunner, make_server

__all__ = ["EngineRunner", "Request", "ServingEngine", "make_server"]
