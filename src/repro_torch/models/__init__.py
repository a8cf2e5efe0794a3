from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, shapes_for
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.encdec import WhisperModel
from repro_torch.models.registry import (abstract_params, analytic_param_count,
                                         build_model, model_flops, param_count)
from repro_torch.models.transformer import TransformerLM, build_plan

__all__ = ["DLRM", "DLRMConfig", "SHAPES", "ModelConfig", "ShapeConfig",
           "shapes_for", "WhisperModel", "abstract_params",
           "analytic_param_count", "build_model", "model_flops",
           "param_count", "TransformerLM", "build_plan"]
