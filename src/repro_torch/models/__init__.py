"""LM model zoo — counterpart of ``repro.models``: of its families, the
dense decoder (``layers``, ``transformer``, ``registry``; serving and
training), the MoE decoder (serving, through the dense dispatch) and the
weight converter ``convert``.  The MoE's mesh dispatches and its training
on the card (ROADMAP Queue 1 items 7.2b, 7.2c), the SSMs, the
encoder-decoder and the VLM (items 7.3, 7.4) wait."""
from .registry import ModelAPI, build_model, cross_entropy

__all__ = ["ModelAPI", "build_model", "cross_entropy"]
