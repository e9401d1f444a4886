"""Gaze models of the port (gaze_grcn, its 7x7 head and gaze_lstm so far),
and the carried-state streaming steps."""
