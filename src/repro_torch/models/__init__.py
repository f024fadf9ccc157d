"""LM model zoo — counterpart of ``repro.models``: every family, each
serving and training: the dense decoder (``layers``, ``transformer``,
``registry``), the MoE decoder (the dense dispatch or a mesh island), the VLM's
patch prefix and the encoder-decoder (``transformer``), mamba2 and the
zamba2 hybrid (``ssm``); and the weight converter ``convert``.  Under an
``axis_rules`` mesh every family runs on DTensors, and the MoE takes its
expert-parallel islands (``layers._apply_moe_ep_a2a``,
``layers._apply_moe_shardmap``)."""
from .registry import ModelAPI, build_model, cross_entropy

__all__ = ["ModelAPI", "build_model", "cross_entropy"]
