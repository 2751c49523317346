"""Model layers and the dense decoder (``transformer``)."""
