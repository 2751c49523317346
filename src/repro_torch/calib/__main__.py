"""``python -m repro_torch.calib``: the calibrate -> plan CLI (calib.plan)."""
from .plan import main

if __name__ == "__main__":
    main()
