"""Stage timing and device traces."""
