"""Gaze models of the port (gaze_grcn and its 7x7 head so far)."""
