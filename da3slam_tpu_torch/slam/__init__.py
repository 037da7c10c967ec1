"""Chunking, chunk alignment, the streaming SLAM solver and the device-resident
pipeline."""
