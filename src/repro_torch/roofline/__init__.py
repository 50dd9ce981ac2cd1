"""Roofline terms for the port's cells (the counterpart of
``repro.roofline``): hardware constants and the three-term bound."""
from repro_torch.roofline.analysis import count_step, roofline_terms  # noqa: F401
from repro_torch.roofline.hw import H100_SXM, TPU_V5E, HwSpec  # noqa: F401
