"""Static knowledge of the port: the knob registry (`analysis.registry`)."""
