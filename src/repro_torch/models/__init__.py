"""LM model zoo — counterpart of ``repro.models``: of its families, the
dense decoder (``layers``, ``transformer``, ``registry``; serving and
training) and the weight converter ``convert``.  MoE, the SSMs, the
encoder-decoder and the VLM wait (ROADMAP Queue 1 items 7.2-7.4)."""
from .registry import ModelAPI, build_model, cross_entropy

__all__ = ["ModelAPI", "build_model", "cross_entropy"]
