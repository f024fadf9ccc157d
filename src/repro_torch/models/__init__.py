"""LM model zoo — counterpart of ``repro.models``: of its families, the
dense decoder (``layers``, ``transformer``, ``registry``), the MoE decoder
(through the dense dispatch), mamba2 and the zamba2 hybrid (``ssm``), each
serving and training, and the weight converter ``convert``.  The MoE's mesh
dispatches (ROADMAP Queue 1 item 7.2b), the encoder-decoder and the VLM
(item 7.4) wait."""
from .registry import ModelAPI, build_model, cross_entropy

__all__ = ["ModelAPI", "build_model", "cross_entropy"]
