"""LM model zoo — counterpart of ``repro.models``: every family, each
serving and training: the dense decoder (``layers``, ``transformer``,
``registry``), the MoE decoder (through the dense dispatch), the VLM's
patch prefix and the encoder-decoder (``transformer``), mamba2 and the
zamba2 hybrid (``ssm``); and the weight converter ``convert``.  The MoE's
mesh dispatches wait (ROADMAP Queue 1 item 7.2b)."""
from .registry import ModelAPI, build_model, cross_entropy

__all__ = ["ModelAPI", "build_model", "cross_entropy"]
