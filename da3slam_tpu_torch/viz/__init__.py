"""Visualisation: the incremental viewer (``viewer``, on viser), the one-shot
prediction viewer, the sky mask, confidence statistics and figures, and the
chunk debug colours."""
