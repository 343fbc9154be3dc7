from repro_torch.trainer.trainers import (DeviceInferProgram,
                                          GSgnnNodeInferer, serve_head)

__all__ = ["DeviceInferProgram", "GSgnnNodeInferer", "serve_head"]
