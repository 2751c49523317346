"""The paper's applications: image sharpening (Table 5) and Sobel edge
detection through the signed multipliers, and the rows of the paper's
tables (``tables``)."""
from . import edge_detection, sharpening  # noqa: F401
