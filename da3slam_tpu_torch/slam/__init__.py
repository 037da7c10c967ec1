"""Chunking, chunk alignment and the streaming SLAM solver."""
