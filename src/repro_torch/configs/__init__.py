from repro_torch.configs.base import (ARCH_IDS, GH200, H200_PCIE, HW_PROFILES,
                                      LONG_CONTEXT_ARCHS, PAPER_MODEL_IDS, SHAPES,
                                      TPU_V5E, AttentionPattern, FrontendConfig,
                                      HardwareProfile, LinkProfile, ModelConfig,
                                      MoEConfig, RotaSchedConfig, ServingConfig,
                                      ShapeConfig, SLOConfig, SSMConfig,
                                      all_arch_ids, get_config, shape_applicable)

__all__ = [
    "ARCH_IDS", "PAPER_MODEL_IDS", "SHAPES", "LONG_CONTEXT_ARCHS",
    "HW_PROFILES", "GH200", "H200_PCIE", "TPU_V5E",
    "ModelConfig", "MoEConfig", "SSMConfig", "AttentionPattern",
    "FrontendConfig", "HardwareProfile", "LinkProfile", "ShapeConfig",
    "ServingConfig", "SLOConfig", "RotaSchedConfig",
    "get_config", "all_arch_ids", "shape_applicable",
]
