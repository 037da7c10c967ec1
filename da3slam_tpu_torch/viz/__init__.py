"""Visualisation helpers: confidence-map statistics and the chunk debug
colours (the viewer and the confidence figures are not ported)."""
