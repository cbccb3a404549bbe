"""Host graph layer: typed relation graphs, splits and the device graph."""
