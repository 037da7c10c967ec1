"""Stage timing."""
