"""Calibration: per-site activation statistics and static scales."""
from .observe import (CalibrationTable, Observer, calibrate_decode,  # noqa: F401
                      observing, site_key)
from .static import (CLIP_MODES, act_quant_clipped,  # noqa: F401
                     apply_calibration, attach_comp_cols)
