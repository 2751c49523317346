"""Calibration and design planning: per-site activation statistics,
static scales and per-layer design plans.

Workflow: prequantize_weights -> calibrate (or calibrate_decode) ->
apply_calibration -> plan_designs -> apply_plan -> serve (launch/serve.py
--plan), or make_plan_injector for QAT (launch/train.py --plan).
"""
from .observe import (CalibrationTable, Observer, calibrate,  # noqa: F401
                      calibrate_decode, observing, site_key)
from .static import (CLIP_MODES, act_quant_clipped,  # noqa: F401
                     apply_calibration, attach_comp_cols, coverage)
from .plan import (DesignPlan, apply_plan, design_cost,  # noqa: F401
                   make_plan_injector, odd_layers, plan_designs,
                   recompose16_frontier, weighted_med)
